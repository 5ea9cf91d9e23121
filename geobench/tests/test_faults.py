"""A run with the timed path broken underneath comes out not correct: the
harness, as it drives a run, with an answer altered where the port
produces it (`eval.engine`'s f* and per-head predictions) in the offline
loop, and in the training loop a step that leaves its state unchanged or
one that leaves half of the batch out. The look for a card is skipped;
the rest of the run is the benchmark's own."""

import pytest
import torch

from geobench.tests import tiny


def _altered(predict_all, what):
    """`predict_all` with the first image's fine (and f*) answer altered:
    its class set to the one the program itself scores lowest ("class"),
    or its coordinates moved by a degree ("coords")."""
    def wrapped(logits_list, harrays):
        preds = predict_all(logits_list, harrays)
        for key in ("fine", "hierarchy"):
            cls, lat, lng = (t.clone() for t in preds[key])
            if what == "class":
                cls[0] = logits_list[-1][0].argmin()
                lat[0], lng[0] = harrays.lats[-1][cls[0]], \
                    harrays.lngs[-1][cls[0]]
            else:
                lat[0] += 1.0
            preds[key] = (cls, lat, lng)
        return preds
    return wrapped


@pytest.mark.parametrize("what", ["class", "coords"])
def test_altered_answer_is_not_correct(monkeypatch, what):
    from geoestimation_tpu_torch.eval import engine

    monkeypatch.setattr(engine, "predict_all",
                        _altered(engine.predict_all, what))
    out = tiny.run(tiny.OFFLINE)
    assert not out.correct
    failed = {name for name, value, limit in out.compared if value > limit}
    assert failed & ({"max_gap", "mean_gap"} if what == "class"
                     else {"coords_off"})


def test_sound_run_is_correct():
    assert tiny.run(tiny.OFFLINE).correct


def test_sound_training_run_is_correct():
    assert tiny.run(tiny.TRAIN).correct


def test_unchanged_state_is_not_correct(monkeypatch):
    """The optimizer counts its step and changes nothing."""
    from geoestimation_tpu_torch.train import optim

    def idle(self):
        self.count += 1

    monkeypatch.setattr(optim.Optimizer, "step", idle)
    out = tiny.run(tiny.TRAIN)
    assert not out.correct
    assert out.readings["change_gap_median"] > 0.9
    assert out.readings["grad_gap_median"] > 0.9


def test_half_the_batch_is_not_correct(monkeypatch):
    """The loss is taken over the first half of the batch's rows, the mean
    over those."""
    from geoestimation_tpu_torch.train import step

    real = step.multi_head_cross_entropy

    def half(logits_list, labels, **kw):
        n = labels.shape[1] // 2
        return real([l[:n] for l in logits_list], labels[:, :n], **kw)

    monkeypatch.setattr(step, "multi_head_cross_entropy", half)
    out = tiny.run(tiny.TRAIN)
    assert not out.correct
