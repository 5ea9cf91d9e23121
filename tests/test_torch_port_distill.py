"""The port's feature-TTA self-distillation (`models/tta_distill.py`)
against the JAX package's on the same seeded weights and images (resnet14,
48-px crops of 64-px bases, level 2, as tests/test_tta_distill.py): the
exact and feature-TTA folded forwards within rtol 1e-4, feature TTA equal to
the exact path where base == crop, one anchored adam step, the `rest`
scope, the verdict pair, and the export through the port's feature-TTA
forward."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geoestimation_tpu.models import qat as jqat
from geoestimation_tpu.models import tta_distill as jtd
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.eval.infer import mean_tta_logits
from geoestimation_tpu_torch.ingest.pipeline import normalize
from geoestimation_tpu_torch.models import qat as pqat
from geoestimation_tpu_torch.models import tta_distill as ptd
from geoestimation_tpu_torch.models.fast_infer import build_feature_tta_apply
from geoestimation_tpu_torch.tools.world import seeded_jax_variables
from geoestimation_tpu_torch.train.optim import Optimizer, constant_schedule
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

ARCH, N_CLASSES = "resnet14", (4, 7)
CROP, LEVEL, N_CROPS = 48, 2, 10
RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    params, stats = seeded_jax_variables(np.random.default_rng(1), ARCH,
                                         N_CLASSES)
    variables = {"params": params, "batch_stats": stats}
    sd = from_jax_variables(params, stats, ARCH, N_CLASSES)
    images = np.random.default_rng(5).integers(0, 256, (3, 64, 64, 3),
                                               dtype=np.uint8)
    return {"variables": variables, "sd": sd, "images": images,
            "jf": jqat.fold_variables(variables, ARCH),
            "x": images.astype(np.float32) - 128.0}


def _applies(crop=CROP, level=LEVEL):
    return ((jtd.build_exact_tta_apply(ARCH, N_CLASSES, crop, N_CROPS),
             jtd.build_ftta_apply(ARCH, N_CLASSES, level, crop, N_CROPS)),
            (ptd.build_exact_tta_apply(ARCH, N_CLASSES, crop, N_CROPS),
             ptd.build_ftta_apply(ARCH, N_CLASSES, level, crop, N_CROPS)))


def _close(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["exact", "ftta"])
def test_folded_forwards_match_jax(tiny, which):
    i = ("exact", "ftta").index(which)
    jax_apply, port_apply = (pair[i] for pair in _applies())
    _close(port_apply(pqat.fold_variables(tiny["sd"], ARCH),
                      torch.from_numpy(tiny["x"])),
           jax.jit(jax_apply)(tiny["jf"], tiny["x"]))


def test_ftta_equals_exact_at_base_equal_crop_and_refusals(tiny):
    """One window when base == crop: the split at level 2 reproduces the
    exact path (the stage split and the window order). The JAX package's
    refusals."""
    exact = ptd.build_exact_tta_apply(ARCH, N_CLASSES, crop=64,
                                      n_crops=N_CROPS)
    ftta = ptd.build_ftta_apply(ARCH, N_CLASSES, level=LEVEL, crop=64,
                                n_crops=N_CROPS)
    pf = pqat.fold_variables(tiny["sd"], ARCH)
    x = torch.from_numpy(tiny["x"])
    for e, f in zip(exact(pf, x), ftta(pf, x)):
        np.testing.assert_allclose(f.numpy(), e.numpy(), rtol=RTOL,
                                   atol=ATOL)
    # base 56: (56 - 48) % (2 * 8) != 0, the center crop off the grid
    with pytest.raises(ValueError, match="aligned"):
        ptd.build_ftta_apply(ARCH, N_CLASSES, LEVEL, CROP, 5)(
            pf, torch.zeros((1, 56, 56, 3)))
    with pytest.raises(ValueError, match="square"):
        ftta(pf, torch.zeros((1, 64, 72, 3)))
    with pytest.raises(ValueError, match="n_crops must be 5 or 10"):
        ptd.build_ftta_apply(ARCH, N_CLASSES, LEVEL, CROP, 1)
    with pytest.raises(ValueError, match="level must be in"):
        ptd.build_ftta_apply(ARCH, N_CLASSES, 4, CROP, N_CROPS)
    with pytest.raises(ValueError, match="train_scope"):
        ptd.make_distill_step(ftta, None, N_CROPS, train_scope="trunk")


def _jax_leaves(folded):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jax.device_get(folded))[0]}


def _as_port(path, a):
    a = np.asarray(a, np.float32)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a[:, None, None] if path.startswith(("stem/", "blocks/")) else a


def test_anchored_adam_step_and_eval_kl_match_jax(tiny):
    """The verdict pair (the exact KL 0 at the start, the student being the
    teacher), the teacher's log-probs, and one anchored adam step against
    optax's: the metrics within rtol 1e-4 (the anchor, the KL of a forward
    with itself, within 1e-6 absolute), each leaf's update within 1e-3 of
    JAX's in relative norm at the median leaf, within 5e-3 at the worst:
    adam's first step is lr * g / (|g| + eps), about lr * sign(g), so an
    element whose gradient is float32 noise moves by 2 lr on a sign flip
    (measured: median 1.0e-4, worst 1.4e-3, the head's kernel)."""
    (j_exact, j_ftta), (p_exact, p_ftta) = _applies()
    base = jnp.asarray(tiny["images"])
    j_teacher = jtd.teacher_log_probs(j_exact, tiny["jf"], base, N_CROPS)
    kf0, ke0 = jax.jit(jtd.make_eval_kl(j_ftta, j_exact, N_CROPS))(
        tiny["jf"], base, j_teacher)

    pf = pqat.fold_variables(tiny["sd"], ARCH, requires_grad=True)
    u8 = torch.from_numpy(tiny["images"])
    p_teacher = ptd.teacher_log_probs(p_exact, pf, u8, N_CROPS)
    for g, r in zip(p_teacher, j_teacher):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    gf, ge = ptd.make_eval_kl(p_ftta, p_exact, N_CROPS)(pf, u8, p_teacher)
    assert float(gf) == pytest.approx(float(kf0), rel=RTOL)
    assert float(ge) == pytest.approx(0.0, abs=1e-5)
    assert float(ke0) == pytest.approx(0.0, abs=1e-5)

    lr = 1e-3
    tx = optax.adam(lr)
    jf, _, jm = jax.jit(jtd.make_distill_step(
        j_ftta, tx, N_CROPS, level=LEVEL, arch=ARCH, exact_apply=j_exact,
        anchor_weight=1.0))(tiny["jf"], tx.init(tiny["jf"]), base,
                            j_teacher)
    before = {p: t.detach().numpy().copy()
              for p, t in pqat.folded_leaves(pf)}
    opt = Optimizer([t for _, t in pqat.folded_leaves(pf)],
                    constant_schedule(lr), "adamw", weight_decay=0.0)
    m = ptd.make_distill_step(p_ftta, opt, N_CROPS, level=LEVEL, arch=ARCH,
                              exact_apply=p_exact, anchor_weight=1.0)(
        pf, u8, p_teacher)
    assert sorted(m) == sorted(jm)
    for k in jm:
        if k == "kl_anchor":
            assert float(m[k]) == pytest.approx(float(jm[k]), abs=1e-6)
        else:
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=RTOL), k
    ref, before_ref = _jax_leaves(jf), _jax_leaves(tiny["jf"])
    errs = {}
    for path, t in pqat.folded_leaves(pf):
        d_ref = _as_port(path, ref[path]) - _as_port(path, before_ref[path])
        d_got = t.detach().numpy() - before[path]
        errs[path] = float(np.linalg.norm(d_got - d_ref)
                           / np.linalg.norm(d_ref))
    worst = max(errs, key=errs.get)
    print(f"adam step: worst leaf update {worst} {errs[worst]:.3g}, median "
          f"{np.median(list(errs.values())):.3g}")
    assert np.median(list(errs.values())) < 1e-3
    assert errs[worst] < 5e-3, (worst, errs[worst])


def test_rest_scope_freezes_the_trunk(tiny):
    """train_scope='rest': the stem and stages 1..level keep their values
    (their gradients zeroed, the leaves still in the optimizer, whose count
    advances); layer3 and the head move."""
    (_, _), (p_exact, p_ftta) = _applies()
    pf = pqat.fold_variables(tiny["sd"], ARCH, requires_grad=True)
    u8 = torch.from_numpy(tiny["images"])
    teacher = ptd.teacher_log_probs(p_exact, pf, u8, N_CROPS)
    before = {p: t.detach().clone() for p, t in pqat.folded_leaves(pf)}
    opt = Optimizer([t for _, t in pqat.folded_leaves(pf)],
                    constant_schedule(5e-3), "sgd", momentum=0.9)
    ptd.make_distill_step(p_ftta, opt, N_CROPS, train_scope="rest",
                          level=LEVEL, arch=ARCH)(pf, u8, teacher)
    after = dict(pqat.folded_leaves(pf))
    assert opt.count == 1
    for path in ("stem/kernel", "blocks/layer1_block0/conv1/kernel",
                 "blocks/layer2_block0/downsample/bias"):
        assert torch.equal(after[path], before[path]), path
    for path in ("blocks/layer3_block0/conv1/kernel",
                 "heads/fused_head/kernel"):
        assert not torch.equal(after[path], before[path]), path


def test_export_through_the_feature_tta_forward(tiny):
    """A distilled network's identity-BN export, served by the port's
    feature-TTA forward (bf16, the engine's `tta_mode="feature"` path),
    gives the folded float32 student's argmax after the TTA fold."""
    pf = pqat.fold_variables(tiny["sd"], ARCH)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for _, t in pqat.folded_leaves(pf):
            t.add_(torch.from_numpy(rng.normal(0, 0.01, tuple(t.shape))
                                    .astype(np.float32)))
    sd = pqat.unfold_to_variables(pf, tiny["sd"], ARCH)
    served = build_feature_tta_apply(sd, ARCH, n_classes=N_CLASSES,
                                     crop=CROP, n_crops=N_CROPS, level=LEVEL,
                                     device="cpu")
    u8 = torch.from_numpy(tiny["images"])
    got = served(normalize(u8))
    want = ptd.build_ftta_apply(ARCH, N_CLASSES, LEVEL, CROP, N_CROPS)(
        pf, u8.float() - 128.0)
    for g, w in zip(got, want):
        gf, wf = mean_tta_logits(g, N_CROPS), mean_tta_logits(w, N_CROPS)
        np.testing.assert_array_equal(gf.argmax(-1).numpy(),
                                      wf.argmax(-1).numpy())


def test_fit_heads_gives_each_family_a_decisive_folded_class():
    """`world.fit_heads` (the distillation world of `chip_smoke.py` phase
    11) on the float32 features of 12 probe images of three families:
    through the folded feature-TTA forward, new images of each family take
    their family's class in every head, by more than the fast path's 0.2."""
    from geoestimation_tpu_torch.ingest.pipeline import eval_pipeline
    from geoestimation_tpu_torch.models.classifier import (
        MultiPartitioningClassifier,
    )
    from geoestimation_tpu_torch.tools import world

    n_classes = (30, 61)
    params, stats = seeded_jax_variables(np.random.default_rng(2), ARCH,
                                         n_classes)
    sd = from_jax_variables(params, stats, ARCH, n_classes)
    model = MultiPartitioningClassifier(n_classes, ARCH, torch.float32)
    model.load_state_dict(sd)
    rng = np.random.default_rng(3)
    probe = torch.as_tensor(world.scene_images(rng, 12, size=64))
    with torch.no_grad():
        feats = model.eval().backbone(eval_pipeline(probe, crop=CROP,
                                                    dtype=torch.float32))
    world.fit_heads(sd, feats, torch.arange(120) // 10 % 3, n_classes)
    assert int((sd["heads.fused_head.weight"].abs().sum(1) > 0).sum()) == 6
    images = world.scene_images(rng, 6, size=64)
    with torch.no_grad():
        logits = ptd.build_ftta_apply(ARCH, n_classes, LEVEL, CROP, N_CROPS)(
            pqat.fold_variables(sd, ARCH),
            torch.as_tensor(images.astype(np.float32) - 128.0))
    for head, classes in zip(logits, world.family_classes(n_classes)):
        folded = mean_tta_logits(head, N_CROPS)
        top2 = folded.topk(2, dim=-1).values
        assert folded.argmax(-1).tolist() == [classes[i % 3]
                                              for i in range(6)]
        assert bool(((top2[:, 0] - top2[:, 1]) > 0.2).all())
