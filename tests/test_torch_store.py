"""The port's snapshot store and panel pipeline against the JAX package's.

The store format is the state carried across: stores written by either
package open in the other, bitwise.  The bf16 encode is pure numpy in the
port and is held bitwise against the JAX codec (which casts with
``ml_dtypes``).  The pipeline's order and byte counters are compared with the
JAX pipeline's on the same store.
"""

import threading

import numpy as np
import pytest
import torch

from repro.core.tiles import StreamStats as JStats
from repro.store import PanelPipeline as JPipeline
from repro.store import TileStore as JStore
from repro.store.tilestore import _f32_to_bf16_u16 as j_encode
from repro_torch.core.tiles import StreamStats, is_streamable, reset_stream_stats, stream_stats
from repro_torch.kernels.ref import decode_bits
from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.store import CachingHandle, PanelPipeline, TileStore, tilestore
from repro_torch.store.pipeline import host_tensor


def _sym(n, seed=0):
    a = np.random.default_rng(seed).uniform(0.1, 1.0, (n, n)).astype(np.float32)
    a = (a + a.T) / 2
    np.fill_diagonal(a, 0.0)
    return a


# ---------------------------------------------------------------------------
# bf16 codec and the int16 carriage of its bits
# ---------------------------------------------------------------------------


def test_bf16_encode_bitwise_vs_jax_codec():
    rng = np.random.default_rng(0)
    tiny = np.finfo(np.float32).tiny
    big = np.finfo(np.float32).max
    special = np.array(
        [0.0, -0.0, 1.0, -1.0, tiny, -tiny, tiny / 3, -tiny / 7, 1e-45, -1e-45,
         big, -big, big * 0.999, 3.4e38, -3.4e38, 65504.0, 1.0e-40],
        np.float32,
    )
    # ties: low 16 bits exactly 0x8000, with even and odd upper halves
    tie_bits = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x00018000, 0x7F7F8000,
                         0x3F80_7FFF, 0x3F80_8001], np.uint32)
    x = np.concatenate([
        rng.normal(size=4096).astype(np.float32) * np.float32(1e3),
        rng.uniform(-1, 1, 4096).astype(np.float32),
        (rng.normal(size=512) * 1e-39).astype(np.float32),  # subnormals
        special,
        tie_bits.view(np.float32),
    ])
    got = tilestore._f32_to_bf16_u16(x)
    want = j_encode(x)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert got[np.nonzero(x == big)[0][0]] == 0x7F80  # the largest finite value rounds to inf


def test_bf16_bits_travel_as_int16_in_both_directions():
    bits = np.random.default_rng(1).integers(0, 1 << 16, size=(40, 24)).astype(np.uint16)
    t = host_tensor(bits)
    assert t.dtype == torch.int16
    np.testing.assert_array_equal(t.numpy().view(np.uint16), bits)  # torch -> numpy
    finite = (bits & 0x7F80) != 0x7F80  # leave NaN payloads out of the value compare
    want = tilestore._bf16_u16_to_f32(bits)
    np.testing.assert_array_equal(decode_bits(t).numpy()[finite], want[finite])
    np.testing.assert_array_equal(decode_bits(t).numpy().view(np.uint32),
                                  bits.astype(np.uint32) << 16)


# ---------------------------------------------------------------------------
# cross-reading stores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["raw", "bf16", "zstd"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_cross_read(tmp_path, codec, writer):
    if codec == "zstd":
        pytest.importorskip("zstandard")
    n, grid = 48, 3
    a = [_sym(n, s) for s in range(2)]
    w_cls, r_cls = (JStore, TileStore) if writer == "jax" else (TileStore, JStore)
    store = w_cls.create(tmp_path, n=n, grid=grid, codec=codec, meta={"seed": 7})
    for i, x in enumerate(a):
        store.put_snapshot(f"t{i}", x)
    other = r_cls.open(tmp_path)
    assert other.snapshot_ids == ["t0", "t1"]
    assert other.manifest.meta == {"seed": 7} and other.manifest.codec == codec
    for i in range(2):
        h_w, h_r = store.snapshot(f"t{i}"), other.snapshot(f"t{i}")
        np.testing.assert_array_equal(h_r.to_numpy(), h_w.to_numpy())
        for r in range(grid):
            for c in range(grid):
                np.testing.assert_array_equal(other.read_tile(f"t{i}", r, c),
                                              store.read_tile(f"t{i}", r, c))
        if codec != "zstd":
            pw, sw, dw = h_w.read_panel_encoded_info(16, 16)
            pr, sr, dr = h_r.read_panel_encoded_info(16, 16)
            np.testing.assert_array_equal(pr, pw)
            assert (sr, dr) == (sw, dw)
    # a store written by one package resumes in the other (same fingerprint)
    resumed = r_cls.create(tmp_path, n=n, grid=grid, codec=codec, meta={"seed": 7})
    assert resumed.snapshot_ids == ["t0", "t1"]


def test_zstd_without_backend_falls_back_to_raw(monkeypatch):
    monkeypatch.setattr(tilestore, "_zstd_backend", lambda: None)
    with pytest.warns(UserWarning, match="falling back to codec='raw'"):
        store = TileStore.create(None, n=32, grid=2, codec="zstd")
    assert store.manifest.codec == "raw" and store.codec.device_decodable
    with pytest.raises(ImportError):
        tilestore.resolve_codec("zstd", fallback=False)
    assert tilestore.Bf16Codec.device_decodable and not tilestore.ZstdCodec.device_decodable


def test_remove_snapshot_and_commit_on_complete(tmp_path):
    store = TileStore.create(tmp_path, n=32, grid=2)
    with pytest.raises(ValueError, match="incomplete"):
        with store.writer("part") as w:
            w.put_tile(0, 0, np.zeros((16, 16), np.float32))
    assert store.snapshot_ids == []
    store.put_snapshot("a", _sym(32))
    store.remove_snapshot("a")
    store.remove_snapshot("part")
    assert TileStore.open(tmp_path).snapshot_ids == []
    assert not (tmp_path / "a").exists() and not (tmp_path / "part").exists()
    assert not list(tmp_path.rglob("*.tmp"))


# ---------------------------------------------------------------------------
# the panel pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["raw", "bf16"])
@pytest.mark.parametrize("encoded", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipeline_order_and_counters_match_jax_host_mode(codec, encoded, depth):
    n, grid = 64, 4
    a, b = _sym(n, 1), _sym(n, 2)
    jstore = JStore.create(None, n=n, grid=grid, codec=codec)
    tstore = TileStore.create(None, n=n, grid=grid, codec=codec)
    jh = [jstore.put_snapshot(s, x) for s, x in (("a", a), ("b", b))]
    th = [tstore.put_snapshot(s, x) for s, x in (("a", a), ("b", b))]
    origins = [32, 0, 48, 16, 16]
    jst, tst = JStats(), StreamStats(MetricsRegistry())
    with JPipeline(jh, origins, 16, depth=depth, stats=jst, encoded=encoded) as jp:
        want = [(r0, [np.asarray(p) for p in ps]) for r0, ps in jp]
    with PanelPipeline(th, origins, 16, depth=depth, stats=tst, encoded=encoded) as tp:
        got = list(tp)
    assert [r0 for r0, _ in got] == origins == [r0 for r0, _ in want]
    for (_, gp), (_, wp) in zip(got, want):
        for g, w in zip(gp, wp):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert tst.snapshot() == jst.snapshot()
    assert tst.bytes_read > 0 and tst.panels == 0  # host mode: nothing staged


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_pipeline_cpu_device_mode_counts_like_jax(ctx1, codec):
    n = 64
    jstore = JStore.create(None, n=n, grid=4, codec=codec)
    tstore = TileStore.create(None, n=n, grid=4, codec=codec)
    jh, th = jstore.put_snapshot("a", _sym(n)), tstore.put_snapshot("a", _sym(n))
    jst, tst = JStats(), StreamStats(MetricsRegistry())
    with JPipeline([jh], range(0, n, 16), 16, sharding=ctx1.sharding(ctx1.matrix_spec),
                   stats=jst, encoded=True) as jp:
        want = [np.asarray(p) for _, (p,) in jp]
    with PanelPipeline([th], range(0, n, 16), 16, device="cpu", stats=tst, encoded=True) as tp:
        got = [p for _, (p,) in tp]
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)
    assert tst.snapshot() == jst.snapshot()
    assert (tst.bytes_h2d_saved > 0) == (codec == "bf16")


def test_pipeline_slices_resident_tensors_alongside_handles():
    n = 32
    a = _sym(n)
    h = TileStore.create(None, n=n, grid=2).put_snapshot("a", a)
    resident = torch.from_numpy(_sym(n, 5))
    with PanelPipeline([h, resident], [16, 0], 16, device="cpu") as pipe:
        for r0, (p_h, p_r) in pipe:
            np.testing.assert_array_equal(p_h.numpy(), a[r0:r0 + 16])
            assert p_r.data_ptr() == resident[r0:r0 + 16].data_ptr()  # sliced, not copied


def test_pipeline_early_exit_cancels_and_errors_reach_the_consumer():
    n = 64
    h = TileStore.create(None, n=n, grid=4).put_snapshot("a", _sym(n))
    pipe = PanelPipeline([h], range(0, n, 16), 16, depth=1)
    for r0, _ in pipe:
        break
    assert pipe._thread is None  # joined on close

    class Broken:
        shape, dtype, panel_rows = (n, n), np.float32, 16

        def read_panel(self, row0, height):
            if row0 == 32:
                raise OSError("disk gone")
            return np.zeros((height, n), np.float32)

    with pytest.raises(RuntimeError, match="prefetch failed at row 32") as err:
        list(PanelPipeline([Broken()], range(0, n, 16), 16))
    assert isinstance(err.value.__cause__, OSError)
    assert is_streamable(Broken()) and not is_streamable(torch.zeros(2, 2))


@pytest.mark.parametrize("fail_at", [None, 40])
def test_pipeline_reads_an_inline_reads_handle_in_windows(fail_at):
    """A handle with ``inline_reads`` is read on the consumer's thread, a
    window of origins at a time, with no prefetch thread; panels arrive in
    order and byte counts match, and a failed read reaches the consumer at
    its row, after the panels before it were yielded."""
    n, h = 64, 4

    class Small:
        shape, dtype, panel_rows = (n, 8), np.float32, h
        inline_reads = True

        def __init__(self):
            self.threads = set()

        def read_panel(self, row0, height):
            self.threads.add(threading.get_ident())
            if row0 == fail_at:
                raise OSError("disk gone")
            return np.full((height, 8), row0, np.float32)

    src, got = Small(), []
    reset_stream_stats()
    m0 = REGISTRY.snapshot()
    pipe = PanelPipeline([src], range(0, n, h), h, device="cpu", stats=stream_stats())
    assert pipe._thread is None
    if fail_at is None:
        got = [(r0, float(p[0, 0])) for r0, (p,) in pipe]
        assert got == [(r, float(r)) for r in range(0, n, h)]
        assert stream_stats().bytes_read == n * 8 * 4
        # the reads are counted once, as fetches: the consumer waits for no thread
        met = REGISTRY.delta(m0)
        assert met["pipeline.panels_fetched"] == n // h
        assert met["pipeline.producer_fetch_seconds"] > 0
        assert met.get("pipeline.consumer_wait_seconds", 0.0) == 0.0
    else:
        with pytest.raises(RuntimeError, match=f"prefetch failed at row {fail_at}") as err:
            for r0, (p,) in pipe:
                got.append(r0)
        assert isinstance(err.value.__cause__, OSError)
        assert got == list(range(0, fail_at - h, h))  # the failed row is staged one ahead
    assert src.threads == {threading.get_ident()}


def test_prefetch_spans_cross_threads():
    n = 32
    h = TileStore.create(None, n=n, grid=2).put_snapshot("a", _sym(n))
    tr = trace.enable_tracing()
    try:
        list(PanelPipeline([h], [0, 16], 16))
    finally:
        trace.disable_tracing()
    spans = [e for e in tr.events() if e["name"] == "prefetch.panel"]
    assert len(spans) >= 2 and all("end_tid" in e["args"] for e in spans[-2:])


def test_caching_handle_replays_report_zero_bytes_read():
    n = 64
    h = TileStore.create(None, n=n, grid=4, codec="bf16").put_snapshot("a", _sym(n))
    cached = CachingHandle(h)
    reset_stream_stats()
    st = stream_stats()
    passes = []
    for _ in range(3):
        with PanelPipeline([cached], range(0, n, 16), 16, device="cpu", stats=st,
                           encoded=True) as pipe:
            passes.append([p.clone() for _, (p,) in pipe])
        if not passes[1:]:
            read_first = st.bytes_read
    assert read_first > 0 and st.bytes_read == read_first  # replays read nothing
    assert st.panels == 12 and cached.fills == 4 and cached.replays == 8
    for p in passes[1:]:
        for x, y in zip(p, passes[0]):
            assert torch.equal(x, y)
    cached.refresh()
    with PanelPipeline([cached], [0], 16, stats=st) as pipe:
        list(pipe)
    assert st.bytes_read > read_first and cached.fills == 5


def test_stream_stats_reset_in_place():
    st = stream_stats()
    st.add(panels=3, bytes_h2d=10)
    st._note_live(99)
    same = reset_stream_stats()
    assert same is st and st.snapshot() == {f: 0 for f in StreamStats.FIELDS} | {"peak_live_bytes": 0}
    with pytest.raises(AttributeError):
        st.add(bogus=1)
