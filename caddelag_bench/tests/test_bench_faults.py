"""With the timed path broken underneath, a run of the tiny cell comes out not correct.

Each test drives a whole run on the CPU (the harness's look for a card
skipped) with one fault planted in the program, and the sound run beside
them comes out correct.  The cells run on one card, so the fault of an
exchange between cards left out does not arise.
"""

import pytest
import torch

from caddelag_bench import harness, reference
from caddelag_bench.tests.cases import TINY, tiny_root  # noqa: F401 -- a fixture

SEED = 2**31 + 99


def _run(root, trace=False):
    cell = harness.find_cell(TINY, root)
    return harness.run_cell(cell, root, seed=SEED, seconds=0.3, trace=trace, device="cpu")


def test_sound_run_is_correct(tiny_root):  # noqa: F811
    assert _run(tiny_root)["correct"] is True


def test_state_left_unchanged_is_caught(tiny_root, monkeypatch):  # noqa: F811
    """Every snapshot after the first gets the first snapshot's embedding again."""
    from repro_torch.core import sequence
    from repro_torch.core.embedding import Embedding

    real = sequence.commute_time_embedding
    kept = []

    def stale(a, cfg, **kw):
        if not kept:  # a private copy: the detector donates the first embedding's memory
            e = real(a, cfg, **kw)
            kept.append(Embedding(z=e.z.clone(), vol=e.vol.clone(), op=None, report=e.report))
            return e
        e = kept[0]
        return Embedding(z=e.z.clone(), vol=e.vol.clone(), op=None, report=e.report)

    monkeypatch.setattr(sequence, "commute_time_embedding", stale)
    out = _run(tiny_root)
    assert out["correct"] is False and out["failed"] >= 1


def test_half_the_nodes_left_out_is_caught(tiny_root, monkeypatch):  # noqa: F811
    """The second half of the nodes get the mean score of the first half."""
    from repro_torch.core import sequence

    real = sequence.node_anomaly_scores

    def half(*args, **kw):
        f = real(*args, **kw)
        n = f.shape[0]
        f[n // 2:] = f[: n // 2].mean()
        return f

    monkeypatch.setattr(sequence, "node_anomaly_scores", half)
    assert _run(tiny_root)["correct"] is False


@pytest.mark.parametrize("where", ["top_id", "score"])
def test_answer_altered_where_produced_is_caught(tiny_root, monkeypatch, where):  # noqa: F811
    """The top node's id swapped for the lowest-scored node's, or one score off by 1%."""
    from repro_torch.core import sequence

    real_top, real_scores = sequence.top_anomalies, sequence.node_anomaly_scores

    def bad_top(scores, k):
        idx, vals = real_top(scores, k)
        idx = idx.clone()
        idx[0] = int(torch.argmin(scores))
        return idx, vals

    def bad_scores(*args, **kw):
        f = real_scores(*args, **kw)
        f[int(torch.argmax(f))] *= 1.01
        return f

    if where == "top_id":
        monkeypatch.setattr(sequence, "top_anomalies", bad_top)
    else:
        monkeypatch.setattr(sequence, "node_anomaly_scores", bad_scores)
    out = _run(tiny_root)
    assert out["correct"] is False
    key = "top_gap" if where == "top_id" else "score_gap"
    assert out["checks"][key]["value"] > out["checks"][key]["limit"]


@pytest.mark.parametrize("precision", ["tf32_chain", "tf32"])
def test_control_in_the_programs_place_is_caught(tiny_root, monkeypatch, precision):  # noqa: F811
    """The reference in a control precision embeds and scores every snapshot instead of the program.

    ``tf32_chain``: the chain's products as one TF32 product each, the rest
    in fp32; ``tf32``: every product in TF32.
    """
    from repro_torch.core import sequence
    from repro_torch.core.embedding import Embedding

    commute = harness.find_cell(TINY, tiny_root).config["commute"]

    def embed(a, cfg, **kw):
        z, vol = reference.embedding(a, commute, precision)
        return Embedding(z=z, vol=vol, op=None, report=None)

    def score(a1, a2, e1, e2, **kw):
        return reference.cad_scores(a1, a2, e1.z, e1.vol, e2.z, e2.vol, precision)

    monkeypatch.setattr(sequence, "commute_time_embedding", embed)
    monkeypatch.setattr(sequence, "node_anomaly_scores", score)
    out = _run(tiny_root)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_embedding_altered_where_produced_is_caught(tiny_root, monkeypatch):  # noqa: F811
    """Each snapshot's Z scaled by 1 + 1e-4 (its scores 2e-4 off, under their limit)."""
    from repro_torch.core import sequence

    real = sequence.commute_time_embedding

    def scaled(a, cfg, **kw):
        e = real(a, cfg, **kw)
        e.z.mul_(1.0001)
        return e

    monkeypatch.setattr(sequence, "commute_time_embedding", scaled)
    out = _run(tiny_root)
    assert out["correct"] is False
    held = [k for k in out["checks"] if k.startswith("z_")]
    assert held and all(out["checks"][k]["value"] > out["checks"][k]["limit"] for k in held)
    assert out["readings"]["z_gap"] == pytest.approx(1e-4, rel=0.01)
    assert out["readings"]["z_rms"] == pytest.approx(1e-4, rel=0.01)
