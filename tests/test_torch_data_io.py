"""The port's data-preparation tools against the JAX package's: cube_io
(PLY per cube + side_info.yaml manifest, byte-identical files, read back)
and download (the manifest, archive unpacking on archives this test
builds, the report of what would be fetched; nothing is ever fetched)."""

import io
import json
import os
import tarfile
import zipfile

import numpy as np
import pytest
import yaml

from upcc_tpu.data import cube_io as JC
from upcc_tpu.data import download as JD
from upcc_tpu.data.synthetic import surface_cloud

from upcc_tpu_torch.data import cube_io as TC
from upcc_tpu_torch.data import download as TD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(5)
    xyz, rgb = surface_cloud(rng, extent=96, n_target=3000)
    return xyz.astype(np.float64), rgb.astype(np.float32)


def _files(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("min_points", [0, 40, 10 ** 9])
def test_cube_io_writes_what_jax_writes(frame, tmp_path, min_points):
    """The same cubes (origins, points, colors), the same cube_*.ply files
    and side_info.yaml byte for byte (no cube kept: ``cubes: []``)."""
    xyz, rgb = frame
    jh, th = JC.CubeHandler(32), TC.CubeHandler(32)
    jcubes, tcubes = jh.slice(xyz, rgb), th.slice(xyz, rgb)
    assert len(jcubes) == len(tcubes) > 1
    for a, b in zip(jcubes, tcubes):
        assert a["origin"] == b["origin"]
        np.testing.assert_array_equal(a["xyz"], b["xyz"])
        np.testing.assert_array_equal(a["rgb"], b["rgb"])
    jd, td = tmp_path / "jax", tmp_path / "port"
    n = jh.write(jcubes, str(jd), min_points=min_points)
    assert th.write(tcubes, str(td), min_points=min_points) == n
    assert _files(jd) == _files(td)
    for name in _files(jd):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    if min_points > 10 ** 6:
        assert n == 0 and "cubes: []" in (td / TC.SIDE_INFO).read_text()


def test_cube_io_reads_back(frame, tmp_path):
    """Both packages read either's directory into the same frame: the
    input's points and 8-bit colors, in cube order."""
    xyz, rgb = frame
    th = TC.CubeHandler(32)
    th.write(th.slice(xyz, rgb), str(tmp_path))
    got = th.read(str(tmp_path))
    ref = JC.CubeHandler(32).read(str(tmp_path))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (len(xyz), 6)
    key = lambda a: np.lexsort(a[:, :3].T)
    np.testing.assert_array_equal(got[key(got), :3],
                                  xyz[key(xyz)].astype(np.float32))


def test_side_info_round_trip_and_refusal():
    info = {"cube_size": 64, "cubes": [
        {"file": "cube_00000.ply", "origin": [0, -64, 128],
         "num_points": 7},
        {"file": "cube_00001.ply", "origin": [64, 0, 0], "num_points": 1}]}
    text = TC.dump_side_info(info)
    assert text == yaml.safe_dump(info)
    assert TC.parse_side_info(text) == info
    assert TC.parse_side_info(yaml.safe_dump({"cube_size": 8, "cubes": []})) \
        == {"cube_size": 8, "cubes": []}
    with pytest.raises(ValueError):
        TC.parse_side_info("cube_size: 8\nextra: 1\n")


def _archive(path, kind, members):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if kind == "zip":
        with zipfile.ZipFile(path, "w") as z:
            for name, data in members.items():
                z.writestr(name, data)
        return
    mode = "w:gz" if path.endswith(".gz") else "w"
    with tarfile.open(path, mode) as t:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))


MEMBERS = {"seq/frame_0000.ply": b"ply\nformat ascii 1.0\nend_header\n",
           "seq/README": b"readme"}


@pytest.mark.parametrize("name", ["a.zip", "b.tar", "c.tar.gz"])
def test_extract_matches_jax(tmp_path, name):
    path = str(tmp_path / "src" / name)
    _archive(path, "zip" if name.endswith(".zip") else "tar", MEMBERS)
    for pkg, fn in (("jax", JD._extract), ("port", TD._extract)):
        fn(path, str(tmp_path / pkg))
        for member, data in MEMBERS.items():
            assert (tmp_path / pkg / member).read_bytes() == data
    assert TD._extract(str(tmp_path / "src" / "x.txt"), str(tmp_path)) \
        is False


def test_download_unpacks_archives_in_place_and_reports_the_rest(
        tmp_path, capsys):
    """Archives already at their places are unpacked; the others are
    reported as what would be fetched.  The URLs are never opened."""
    manifest = {
        "setA": {"url": "https://example.invalid/pcs/setA.tar",
                 "sequences": ["s1"]},
        "setB": {"s2": "https://example.invalid/pcs/s2.zip",
                 "s3": "https://example.invalid/pcs/s3.tar.gz"},
    }
    mpath = tmp_path / "manifest.json"
    mpath.write_text(json.dumps(manifest))
    dest = tmp_path / "raw"
    _archive(str(dest / "setA" / "setA.tar"), "tar", MEMBERS)
    _archive(str(dest / "setB" / "s2.zip"), "zip", MEMBERS)
    got = TD.download_datasets(str(mpath), str(dest))
    assert got == [str(dest / "setA" / "setA.tar"),
                   str(dest / "setB" / "s2.zip")]
    for folder in ("setA", "setB"):
        for member, data in MEMBERS.items():
            assert (dest / folder / member).read_bytes() == data
    out = capsys.readouterr().out
    assert "would fetch https://example.invalid/pcs/s3.tar.gz" in out
    assert str(dest / "setB" / "s3.tar.gz") in out
    assert out.count("would fetch") == 1


def test_manifests():
    """The default manifest is the JAX package's; the committed registry
    lists its 26 sequence archives, every one reported."""
    assert TD.DEFAULT_MANIFEST == JD.DEFAULT_MANIFEST
    with open(os.path.join(ROOT, "data", "config",
                           "download_paths.yaml")) as f:
        reg = yaml.safe_load(f)
    entries = TD.archives(reg, "/raw")
    assert len(entries) == sum(len(v) for v in reg.values()) == 26
    name, url, path, seqs = entries[0]
    assert (name, seqs) == ("mvub", ["andrew9"])
    assert path == "/raw/mvub/andrew9.zip" and url.endswith("andrew9.zip")
    assert [e[3] for e in TD.archives(JD.DEFAULT_MANIFEST, "/raw")] == [
        v["sequences"] for v in JD.DEFAULT_MANIFEST.values()]
