"""The port's partitioning and data-prep tools against the JAX package's:
`geo.create_cells` bit for bit on seeded coordinates, the native S2 library
against the numpy path and the JAX package's library, the two partitioning
CLIs and the filter byte for byte, the downloader's offline helpers and a
download from local `file://` JPEGs, and `tools.make_demo_world` file for
file. Host numpy work: every comparison is exact."""

import filecmp
import importlib
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from geoestimation_tpu.geo import create_cells as jax_create_cells
from geoestimation_tpu.geo import s2 as jax_s2
from geoestimation_tpu_torch.geo import create_cells, native, s2

REPO = Path(__file__).resolve().parents[1]
JAX_S2_DIR = REPO / "geoestimation_tpu" / "geo" / "cpp"
# above s2._NATIVE_MIN_N, so create_cells takes the native path where it
# builds
N_POINTS = 20_000


def _coords(seed=0, n=N_POINTS):
    """Clustered coordinates around four cities plus a uniform background."""
    rng = np.random.default_rng(seed)
    centers = np.array([(48.85, 2.35), (40.71, -74.0), (35.68, 139.65),
                        (-33.87, 151.21)])
    k = rng.integers(0, len(centers), n - n // 5)
    lat = np.concatenate([centers[k, 0] + rng.normal(0, 0.5, len(k)),
                          rng.uniform(-80, 80, n // 5)])
    lng = np.concatenate([centers[k, 1] + rng.normal(0, 0.5, len(k)),
                          rng.uniform(-180, 180, n // 5)])
    return lat, lng


def _numpy_leaf_ids(mod, lat, lng):
    """A module's numpy leaf-id pipeline, bypassing the native dispatch."""
    face, u, v = mod.xyz_to_face_uv(mod.latlng_to_xyz(lat, lng))
    return mod.from_face_ij(face, mod.st_to_ij(mod.uv_to_st(u)),
                            mod.st_to_ij(mod.uv_to_st(v)))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's S2 library, built by its own Makefile in a copy of
    its directory (no other test's build of the same file is raced), loaded
    through its `geo.native`."""
    directory = tmp_path_factory.mktemp("jax_s2")
    for name in ("Makefile", "s2geo.cpp"):
        shutil.copy(JAX_S2_DIR / name, directory)
    build = subprocess.run(["make", "-C", str(directory), "libs2geo.so"],
                           capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-2000:]
    mod = importlib.import_module("geoestimation_tpu.geo.native")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "_SO_PATH", str(directory / "libs2geo.so"))
        mp.setattr(mod, "_TRIED", False)
        mp.setattr(mod, "_LIB", None)
        assert mod.available()
        yield mod


# -- the native S2 library ------------------------------------------------------

def test_native_builds_into_a_hashed_build_path():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    path = native.library_path()
    assert path.parent == REPO / "build" / "s2geo"
    assert path.name.startswith("libs2geo-") and path.exists()


def test_native_equals_numpy_and_jax_native(jax_native):
    lat, lng = _coords(1)
    lat[:4] = [90.0, -90.0, 0.0, 45.0]
    lng[:4] = [0.0, 180.0, -180.0, 90.0]
    ids = native.latlng_to_cell_id(lat, lng)
    np.testing.assert_array_equal(ids, _numpy_leaf_ids(s2, lat, lng))
    np.testing.assert_array_equal(ids, jax_native.latlng_to_cell_id(lat, lng))
    np.testing.assert_array_equal(ids, _numpy_leaf_ids(jax_s2, lat, lng))
    for level in (0, 2, 13, 29, 30):
        parents = native.parent_at_level(ids, level)
        np.testing.assert_array_equal(parents, s2.parent_at_level(ids, level))
        np.testing.assert_array_equal(
            parents, jax_native.parent_at_level(ids, level))
        np.testing.assert_array_equal(native.cell_level(parents),
                                      jax_native.cell_level(parents))
        np.testing.assert_array_equal(native.cell_level(parents),
                                      s2.cell_level(parents))
        for got, ref in zip(native.cell_id_to_latlng(parents),
                            jax_native.cell_id_to_latlng(parents)):
            np.testing.assert_array_equal(got, ref)


def test_dispatch_takes_native_above_the_threshold_unless_disabled(
        monkeypatch):
    lat, lng = _coords(2)
    calls = []
    real = native.latlng_to_cell_id
    monkeypatch.setattr(native, "latlng_to_cell_id",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    got = s2.latlng_to_cell_id(lat, lng)
    small = s2.latlng_to_cell_id(lat[:100], lng[:100])
    assert calls == [N_POINTS]
    monkeypatch.setenv("GEOESTIMATION_NO_NATIVE_S2", "1")
    assert s2._native() is None
    np.testing.assert_array_equal(s2.latlng_to_cell_id(lat, lng), got)
    assert calls == [N_POINTS]
    np.testing.assert_array_equal(small, got[:100])


# -- create_cells ---------------------------------------------------------------

@pytest.mark.parametrize("img_min, img_max, lvl_min, lvl_max", [
    (50, 1000, 2, 30), (10, 300, 2, 30), (5, 200, 4, 9)])
def test_create_cells_matches_jax(img_min, img_max, lvl_min, lvl_max,
                                  capsys):
    """Tokens, ids, counts, mean lat/lng, the kept count, the rounds and the
    verbose progress lines, exactly."""
    lat, lng = _coords(3)
    kw = dict(img_min=img_min, img_max=img_max, lvl_min=lvl_min,
              lvl_max=lvl_max, verbose=True)
    got = create_cells(lat, lng, **kw)
    got_lines = capsys.readouterr().out
    ref = jax_create_cells(lat, lng, **kw)
    assert got_lines == capsys.readouterr().out and "round 0:" in got_lines
    g, r = got.partitioning, ref.partitioning
    assert len(g) > 10 and g.name == r.name == f"cells_{img_min}_{img_max}"
    np.testing.assert_array_equal(g.tokens, r.tokens)
    for f in ("cell_ids", "counts", "lat", "lng", "levels"):
        a, b = getattr(g, f), getattr(r, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.n_images_total, got.n_images_kept, got.n_rounds) == (
        ref.n_images_total, ref.n_images_kept, ref.n_rounds)


def test_create_cells_native_and_numpy_agree(monkeypatch):
    lat, lng = _coords(4)
    a = create_cells(lat, lng, img_min=20, img_max=500).partitioning
    monkeypatch.setenv("GEOESTIMATION_NO_NATIVE_S2", "1")
    b = create_cells(lat, lng, img_min=20, img_max=500).partitioning
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.lat, b.lat)


# -- the partitioning CLIs --------------------------------------------------------

@pytest.fixture(scope="module")
def meta_csv(tmp_path_factory):
    root = tmp_path_factory.mktemp("meta")
    lat, lng = _coords(5, n=12_000)
    path = root / "meta.csv"
    pd.DataFrame({"IMG_ID": [f"img_{i:05d}" for i in range(len(lat))],
                  "LAT": lat, "LON": lng}).to_csv(path, index=False)
    return path


def _run_both(port_main, jax_main, argv_of, tmp_path, capsys):
    """Each CLI's main on its own output path; (port bytes, JAX bytes) and
    both stdouts with the paths made equal."""
    outs = []
    for tag, main in (("port", port_main), ("jax", jax_main)):
        out = tmp_path / f"{tag}.csv"
        main(argv_of(str(out)))
        printed = capsys.readouterr().out.replace(str(out), "OUT")
        outs.append((out.read_bytes(), printed))
    return outs


@pytest.mark.parametrize("flags", [
    [], ["-v", "--img_min", "10", "--img_max", "400"],
    ["--img_min", "5", "--img_max", "300", "--lvl_min", "3", "--lvl_max",
     "10", "--column_lat", "lat", "--column_lng", "lon"]])
def test_create_cells_cli_writes_jax_bytes(meta_csv, flags, tmp_path,
                                           capsys):
    from geoestimation_tpu_torch.partitioning.create_cells import main
    from partitioning.create_cells import main as jax_main

    (got, got_out), (ref, ref_out) = _run_both(
        main, jax_main,
        lambda out: ["--dataset", str(meta_csv), "--output", out, *flags],
        tmp_path, capsys)
    assert got == ref and got_out == ref_out
    assert "cells (" in got_out


def test_create_cells_cli_bad_column_as_jax(meta_csv):
    from geoestimation_tpu_torch.partitioning.create_cells import main
    from partitioning.create_cells import main as jax_main

    argv = ["--dataset", str(meta_csv), "--output", "unused.csv",
            "--column_lat", "NOPE"]
    with pytest.raises(SystemExit) as ref:
        jax_main(argv)
    with pytest.raises(SystemExit, match="column 'NOPE'") as got:
        main(argv)
    assert str(got.value) == str(ref.value)


@pytest.fixture(scope="module")
def cell_files(meta_csv, tmp_path_factory):
    from geoestimation_tpu_torch.partitioning.create_cells import main

    root = tmp_path_factory.mktemp("cells")
    files = []
    for img_max in (5000, 2000, 1000):
        path = str(root / f"cells_50_{img_max}.csv")
        main(["--dataset", str(meta_csv), "--output", path, "--img_max",
              str(img_max)])
        files.append(path)
    return files


@pytest.mark.parametrize("flags", [
    [], ["--drop_unassigned"], ["--shortnames", "a", "b", "c"]])
def test_assign_classes_cli_writes_jax_bytes(meta_csv, cell_files, flags,
                                             tmp_path, capsys):
    from geoestimation_tpu_torch.partitioning.assign_classes import main
    from partitioning.assign_classes import main as jax_main

    (got, got_out), (ref, ref_out) = _run_both(
        main, jax_main,
        lambda out: ["--dataset", str(meta_csv), "--output", out,
                     "--cell_files", *cell_files, *flags],
        tmp_path, capsys)
    assert got == ref and got_out == ref_out
    header = got.split(b"\n", 1)[0]
    assert header == (b"IMG_ID,a,b,c" if "--shortnames" in flags
                      else b"IMG_ID,coarse,middle,fine")


@pytest.mark.parametrize("cli", ["create_cells", "assign_classes"])
def test_cli_runs_by_path(cli, meta_csv, cell_files, tmp_path):
    """`python geoestimation_tpu_torch/partitioning/<cli>.py` from another
    directory, as `-m` runs it."""
    script = REPO / "geoestimation_tpu_torch" / "partitioning" / f"{cli}.py"
    out = tmp_path / "out.csv"
    argv = ["--dataset", str(meta_csv), "--output", str(out)]
    if cli == "assign_classes":
        argv += ["--cell_files", *cell_files]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script), *argv],
                          cwd=str(tmp_path), capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert out.stat().st_size > 0 and str(out) in proc.stdout


# -- the filter and the downloader -----------------------------------------------

def _jpeg(rng, side=32):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (side, side, 3),
                                 dtype=np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def test_filter_writes_jax_bytes(tmp_path, capsys):
    from filter_by_downloaded_images import main as jax_main
    from geoestimation_tpu_torch.data import shards
    from geoestimation_tpu_torch.tools.filter_by_downloaded_images import (
        main,
    )

    rng = np.random.default_rng(6)
    for k in range(2):
        shards.write_shard([{"id": f"a{k}{i}", "image": _jpeg(rng)}
                            for i in range(3 + k)],
                           str(tmp_path / f"s{k}.msgpack"))
    labels = tmp_path / "labels.csv"
    ids = [f"a{k}{i}" for k in range(2) for i in range(6)]
    pd.DataFrame({"IMG_ID": ids, "coarse": range(len(ids))}).to_csv(
        labels, index=False)
    outs = []
    for tag, fn in (("port", main), ("jax", jax_main)):
        fn(["--shards", str(tmp_path / "s*.msgpack"), "--labels",
            str(labels), "--suffix", f"_kept_by_{tag}"])
        outs.append((capsys.readouterr().out.replace(f"_kept_by_{tag}", ""),
                     (tmp_path / f"labels_kept_by_{tag}.csv").read_bytes()))
    assert outs[0] == outs[1]
    kept = pd.read_csv(tmp_path / "labels_kept_by_port.csv")
    assert sorted(kept.IMG_ID) == sorted(f"a{k}{i}" for k in range(2)
                                         for i in range(3 + k))


@pytest.mark.parametrize("url, suffix", [
    ("http://x/y/12.jpg", "z"), ("http://x/y/12.jpg", ""),
    ("http://x/y/12", "b"), ("file:///t/a.b/c.jpeg", "z")])
def test_apply_size_suffix_as_jax(url, suffix):
    from download_images import apply_size_suffix as jax_fn
    from geoestimation_tpu_torch.tools.download_images import (
        apply_size_suffix,
    )

    assert apply_size_suffix(url, suffix) == jax_fn(url, suffix)


@pytest.mark.parametrize("text", [
    "id,url\nA,http://h/a.jpg\nB,http://h/b.jpg\n",
    "A,http://h/a.jpg\nB,x,http://h/b.jpg\nshort\n"])
def test_iter_url_rows_as_jax(text, tmp_path):
    from download_images import iter_url_rows as jax_fn
    from geoestimation_tpu_torch.tools.download_images import iter_url_rows

    path = tmp_path / "urls.csv"
    path.write_text(text)
    assert list(iter_url_rows(str(path))) == list(jax_fn(str(path)))


def test_download_from_local_files_into_shards(tmp_path, capsys):
    """Local `file://` JPEGs (one missing) into shards of 2: the records
    hold the files' bytes; the messages and exit code are the JAX tool's."""
    from download_images import main as jax_main
    from geoestimation_tpu_torch.data.shards import iter_records
    from geoestimation_tpu_torch.tools.download_images import main

    rng = np.random.default_rng(7)
    blobs = {}
    for i in range(5):
        blobs[f"im{i}"] = _jpeg(rng)
        (tmp_path / f"im{i}.jpg").write_bytes(blobs[f"im{i}"])
    urls = tmp_path / "urls.csv"
    urls.write_text("id,url\n" + "".join(
        f"im{i},{(tmp_path / f'im{i}.jpg').as_uri()}\n" for i in range(6)))
    outs = []
    for tag, fn in (("port", main), ("jax", jax_main)):
        out = tmp_path / tag
        rc = fn(["--output", str(out), "--url_csv", str(urls),
                 "--size_suffix", "", "--shard_size", "2", "--num_workers",
                 "2", "--shuffle"])
        outs.append((rc, capsys.readouterr().out.replace(str(out), "OUT")))
    assert outs[0] == outs[1] and outs[0][0] == 0
    assert "5 downloaded, 1 failed, 3 shards" in outs[0][1]
    got = {r["id"]: r["image"] for r in iter_records(
        [str(tmp_path / "port" / "*.msgpack")])}
    assert got == blobs


def test_download_exits_1_when_every_url_fails(tmp_path, capsys):
    from geoestimation_tpu_torch.tools.download_images import main

    urls = tmp_path / "urls.csv"
    urls.write_text(f"id,url\na,{(tmp_path / 'missing.jpg').as_uri()}\n")
    assert main(["--output", str(tmp_path / "o"), "--url_csv", str(urls),
                 "--size_suffix", ""]) == 1
    assert "no network egress" in capsys.readouterr().err


# -- make_demo_world -------------------------------------------------------------

def _tree(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*")
                  if p.is_file())


@pytest.mark.parametrize("flags", [
    [],
    ["--style", "textured", "--scene_style", "texture", "--geometry",
     "realistic", "--scene_world", "--image_size", "64", "--arch",
     "resnet14", "--seed", "3"]])
def test_make_demo_world_writes_jax_files(flags, tmp_path, capsys):
    """The same meta and label CSVs, cells, shards, images and YAML (the
    YAMLs name their own roots)."""
    from geoestimation_tpu_torch.tools.make_demo_world import main
    from tools.make_demo_world import main as jax_main

    roots = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    printed = {}
    for tag, fn in (("port", main), ("jax", jax_main)):
        fn(["--output", str(roots[tag]), "--n_train", "24", "--n_eval", "3",
            *flags])
        printed[tag] = capsys.readouterr().out.replace(str(roots[tag]),
                                                       "ROOT")
    assert printed["port"] == printed["jax"]
    files = _tree(roots["port"])
    assert files == _tree(roots["jax"])
    for rel in ("demo.yml", "isn.yml", "train_labels.csv", "eval_meta.csv",
                "resources/s2_cells/cells_50_1000.csv",
                "shards/shard_00000.msgpack", "eval_images/eval_0002.jpg"):
        assert Path(rel) in files, rel
    for rel in files:
        a, b = roots["port"] / rel, roots["jax"] / rel
        if rel.suffix == ".yml":
            assert a.read_text().replace(str(roots["port"]), "ROOT") == \
                b.read_text().replace(str(roots["jax"]), "ROOT"), rel
        else:
            assert filecmp.cmp(a, b, shallow=False), rel
