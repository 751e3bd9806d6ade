"""The port's embedding store against the JAX package's.

An embedding artifact is the state the query read path carries across: a
store written by either package opens in the other, with an equal manifest
and bitwise-equal panels and sidecar, for the raw and the bf16 codec.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch
from repro.kernels.tiling import fit as j_fit
from repro.store import TileStore as JTileStore
from repro.store.embstore import EmbeddingStore as JEmbStore
from repro.store.embstore import default_panel_rows as j_default_panel_rows
from repro_torch.store import EmbeddingStore, TileStore, default_panel_rows
from repro_torch.store.embstore import fit

N, K = 96, 12


def _artifact(seed=0, n=N, k=K):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, k)).astype(np.float32)
    deg = rng.uniform(0.5, 3.0, size=n).astype(np.float32)
    deg[5] = 0.0  # an isolated node: inv_deg maps it to 0
    return z, float(rng.uniform(10, 100)), deg


def _write(cls, root, codec, n_ids=2):
    store = cls.create(root, n=N, k=K, codec=codec, seed=3, panel_rows=32,
                       meta={"dataset": "gmm", "n": N})
    for t in range(n_ids):
        store.put_embedding(f"t{t:04d}", *_artifact(t))
    return store


@pytest.mark.parametrize("codec", ["raw", "bf16"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stores_cross_read_bitwise(tmp_path, codec, writer):
    w_cls, r_cls = (JEmbStore, EmbeddingStore) if writer == "jax" else (EmbeddingStore, JEmbStore)
    _write(w_cls, tmp_path / "a", codec)
    mirror = _write(r_cls, tmp_path / "b", codec)  # the same artifacts from the other package
    assert (tmp_path / "a" / "manifest.json").read_text() == \
        (tmp_path / "b" / "manifest.json").read_text()
    opened = r_cls.open(tmp_path / "a")
    assert json.loads(opened.manifest.to_json()) == json.loads(mirror.manifest.to_json())
    for eid in ("t0000", "t0001"):
        for p in range(N // 32):
            got = opened.read_panel_stored(eid, p)
            want = mirror.read_panel_stored(eid, p)
            assert got.dtype == want.dtype == (np.uint16 if codec == "bf16" else np.float32)
            np.testing.assert_array_equal(got, want)
            assert (tmp_path / "a" / eid / f"z_{p:04d}.npy").read_bytes() == \
                (tmp_path / "b" / eid / f"z_{p:04d}.npy").read_bytes()
        ha, hb = opened.embedding(eid), mirror.embedding(eid)
        np.testing.assert_array_equal(ha.to_numpy(), hb.to_numpy())
        for name in ("deg", "zbar"):
            np.testing.assert_array_equal(getattr(ha, name), getattr(hb, name))
        assert ha.vol == hb.vol
        np.testing.assert_array_equal(ha.inv_deg(), hb.inv_deg())
        np.testing.assert_array_equal(ha.read_rows([0, 33, 95]), hb.read_rows([0, 33, 95]))
        pa, sa, da = ha.read_panel_encoded_info(32, 64)
        pb, sb, db = hb.read_panel_encoded_info(32, 64)
        np.testing.assert_array_equal(pa, pb)
        assert (sa, da) == (sb, db)


@pytest.mark.parametrize("n", [64, 96, 128, 1536, 10512, 259200, 97])
def test_default_panel_rows_equals_jax(n):
    assert default_panel_rows(n) == j_default_panel_rows(n)
    for want in (16, 128, 256, 1024):
        assert fit(n, want) == j_fit(n, want)


def test_default_panel_rows_at_the_main_paths_sizes():
    assert default_panel_rows(10512) == 144  # 73 panels
    assert default_panel_rows(259200) == 128  # 2025 panels


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_ram_backend_roundtrip(codec):
    z, vol, deg = _artifact()
    stores = [cls.create(None, n=N, k=K, codec=codec, seed=3, panel_rows=32)
              for cls in (EmbeddingStore, JEmbStore)]
    for s in stores:
        s.put_embedding("t0000", z, vol, deg)
    hp, hj = (s.latest() for s in stores)
    np.testing.assert_array_equal(hp.to_numpy(), hj.to_numpy())
    np.testing.assert_array_equal(hp.zbar, hj.zbar)
    assert hp.vol == hj.vol == vol
    tol = dict(rtol=1e-2, atol=1e-2) if codec == "bf16" else dict(rtol=0, atol=0)
    np.testing.assert_allclose(hp.to_numpy(), z, **tol)
    assert stores[0].panel_nbytes_stored("t0000", 0) == stores[1].panel_nbytes_stored("t0000", 0)


def test_bf16_stored_form_is_half_width(tmp_path):
    z, vol, deg = _artifact()
    store = EmbeddingStore.create(tmp_path, n=N, k=K, codec="bf16", panel_rows=32)
    store.put_embedding("t0000", z, vol, deg)
    stored = store.read_panel_stored("t0000", 0)
    assert stored.dtype == np.uint16 and stored.nbytes * 2 == z[:32].nbytes
    panel, nbytes, decoded = store.latest().read_panel_encoded_info(0, 32)
    assert panel.dtype == np.uint16 and decoded == 2 * panel.nbytes


@pytest.mark.parametrize("cls", [EmbeddingStore, JEmbStore], ids=["torch", "jax"])
def test_fingerprint_and_meta_mismatch_rejected(tmp_path, cls):
    cls.create(tmp_path, n=64, k=8, seed=0, meta={"dataset": "gmm"})
    for other in (dict(k=16, seed=0), dict(k=8, seed=1), dict(k=8, seed=0, codec="bf16")):
        for opener in (EmbeddingStore, JEmbStore):
            with pytest.raises(ValueError, match="fingerprint"):
                opener.create(tmp_path, n=64, **other)
    for opener in (EmbeddingStore, JEmbStore):
        with pytest.raises(ValueError, match="different content"):
            opener.create(tmp_path, n=64, k=8, seed=0, meta={"dataset": "climate"})
        assert opener.create(tmp_path, n=64, k=8, seed=0).manifest.meta == {"dataset": "gmm"}


def test_tilestore_dirs_rejected_by_both(tmp_path):
    TileStore.create(tmp_path / "port", n=64, grid=2)
    JTileStore.create(tmp_path / "jax", n=64, grid=2)
    for root in ("port", "jax"):
        for opener in (EmbeddingStore, JEmbStore):
            with pytest.raises(ValueError, match="not an embedding store"):
                opener.open(tmp_path / root)


def test_zstd_codec_rejected():
    with pytest.raises(ValueError, match="device-decodable"):
        EmbeddingStore.create(None, n=64, k=8, codec="zstd")


def test_torn_publish_is_never_served_and_resumes(tmp_path):
    store = EmbeddingStore.create(tmp_path, n=64, k=8, panel_rows=16)
    z, vol, deg = _artifact(n=64, k=8)
    store._store_panel("torn", 0, np.asarray(store.codec.encode(z[:16])))  # crash mid-publish
    with pytest.raises(ValueError, match="incomplete"):
        store._commit("torn")
    assert "torn" not in EmbeddingStore.open(tmp_path).embedding_ids
    with pytest.raises(KeyError):
        store.embedding("torn")
    # the JAX package resumes a torn publish of the port's in place, and the reverse
    JEmbStore.create(tmp_path, n=64, k=8, panel_rows=16).put_embedding("torn", z, vol, deg)
    assert EmbeddingStore.open(tmp_path).embedding_ids == ["torn"]
    store.remove_embedding("torn")
    assert store.embedding_ids == [] and not (tmp_path / "torn").exists()
    j = JEmbStore.open(tmp_path)
    j._store_panel("t1", 1, np.asarray(j.codec.encode(z[16:32])))
    h = EmbeddingStore.open(tmp_path).put_embedding("t1", z, vol, deg)
    np.testing.assert_array_equal(h.to_numpy(), z)
    assert JEmbStore.open(tmp_path).embedding_ids == ["t1"]


def test_bad_ids_and_shapes_rejected():
    store = EmbeddingStore.create(None, n=64, k=8)
    z, vol, deg = _artifact(n=64, k=8)
    for bad in ("", ".", "..", "a/b"):
        with pytest.raises(ValueError, match="bad embedding id"):
            store.put_embedding(bad, z, vol, deg)
    with pytest.raises(ValueError, match="store holds"):
        store.put_embedding("t", z[:, :4], vol, deg)
    with pytest.raises(ValueError, match="deg is"):
        store.put_embedding("t", z, vol, deg[:10])
    with pytest.raises(KeyError, match="empty"):
        store.latest()
    with pytest.raises(ValueError, match="must divide"):
        EmbeddingStore.create(None, n=64, k=8, panel_rows=48)
    with pytest.raises(ValueError, match="panel-aligned"):
        store.put_embedding("t", z, vol, deg).read_panel(3, 16)


def test_put_embedding_takes_tensors():
    import torch

    z, vol, deg = _artifact(n=64, k=8)
    store = EmbeddingStore.create(None, n=64, k=8)
    h = store.put_embedding("t0000", torch.from_numpy(z), torch.tensor(vol), torch.from_numpy(deg))
    np.testing.assert_array_equal(h.to_numpy(), z)
    assert h.vol == np.float64(np.float32(vol))


@pytest.mark.parametrize("form", ["c_v1", "uint16_v1", "c_v2", "fortran"])
def test_panel_reader_matches_np_load(tmp_path, form):
    from repro_torch.store.embstore import _read_npy

    a = np.random.default_rng(0).normal(size=(48, 7)).astype(np.float32)
    if form == "uint16_v1":
        a = (a * 1000).astype(np.uint16)
    if form == "fortran":
        a = np.asfortranarray(a)
    path = tmp_path / "p.npy"
    with open(path, "wb") as f:
        np.lib.format.write_array(f, a, version=(2, 0) if form == "c_v2" else (1, 0))
    # a hint shorter than the header, than the data, and longer than the file;
    # the second and later reads take the cached header
    for hint in (4, 100, 1 << 16, 1 << 16):
        got, nbytes = _read_npy(path, hint)
        np.testing.assert_array_equal(got, np.load(path))
        assert got.dtype == a.dtype and got.shape == a.shape
        assert nbytes == path.stat().st_size


@pytest.mark.parametrize("writer", ["another process", "another store"])
def test_kept_panel_maps_follow_a_republish(tmp_path, writer):
    """A store keeps its panel files mapped between queries, and a handle
    checks them once against the artifact's sidecar: an id that another
    process or store removed and published again reads its new panels."""
    z1, vol1, deg1 = _artifact(1)
    z2, vol2, deg2 = _artifact(2)
    st = EmbeddingStore.create(tmp_path / "s", n=N, k=K, panel_rows=16)
    np.testing.assert_array_equal(st.put_embedding("a", z1, vol1, deg1).to_numpy(), z1)
    assert st._n_maps == N // 16  # every panel of "a" mapped
    np.save(tmp_path / "z2.npy", z2)
    np.save(tmp_path / "deg2.npy", deg2)
    code = (
        "import sys, numpy as np\n"
        "from repro_torch.store import EmbeddingStore\n"
        "st = EmbeddingStore.open(sys.argv[1])\n"
        "st.remove_embedding('a')\n"
        "st.put_embedding('a', np.load(sys.argv[2]), float(sys.argv[3]), np.load(sys.argv[4]))\n"
    )
    args = [str(tmp_path / "s"), str(tmp_path / "z2.npy"), repr(vol2), str(tmp_path / "deg2.npy")]
    if writer == "another process":
        src = Path(repro_torch.__file__).resolve().parents[1]
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(src), *filter(None, [os.environ.get("PYTHONPATH")])])}
        subprocess.run([sys.executable, "-c", code, *args], check=True, env=env, timeout=120)
    else:
        other = EmbeddingStore.open(tmp_path / "s")
        other.remove_embedding("a")
        other.put_embedding("a", z2, vol2, deg2)
    h = st.embedding("a")
    np.testing.assert_array_equal(h.to_numpy(), z2)
    np.testing.assert_array_equal(h.read_rows([0, 17, 95]), z2[[0, 17, 95]])
    assert h.vol == vol2 and st._n_maps == N // 16  # the old set closed, the new one kept
    st.remove_embedding("a")
    assert st._n_maps == 0


def test_kept_panel_maps_stay_within_the_limit(tmp_path):
    """At most ``maps_limit`` panel files stay mapped: other artifacts' maps
    make room, and the panels of one artifact past the limit are read from
    their files; every read returns the committed bytes."""
    z1, vol, deg = _artifact(1)
    z2, _, _ = _artifact(2)
    st = EmbeddingStore.create(tmp_path, n=N, k=K, panel_rows=16)  # six panels
    st.maps_limit = 4
    ha, hb = st.put_embedding("a", z1, vol, deg), st.put_embedding("b", z2, vol, deg)
    for _ in range(2):
        np.testing.assert_array_equal(ha.to_numpy(), z1)
        assert st._n_maps == 4 and len(ha._panel_maps().maps) == 4
    np.testing.assert_array_equal(hb.to_numpy(), z2)
    assert st._n_maps == 4 and list(st._maps) == ["b"] and ha._panel_maps().closed
    np.testing.assert_array_equal(ha.to_numpy(), z1)  # a closed set: read from the files
    np.testing.assert_array_equal(st.embedding("a").to_numpy(), z1)
    assert st._n_maps == 4 and list(st._maps) == ["a"]
