"""The operation and byte counts behind the rooflines and ``mfu_pct``, at the
cells' logical shapes (21,818 videos x 100 clips, D 256, no padding)."""
from __future__ import annotations

import math

import numpy as np
import pytest

from benchmarks import harness, peaks
from benchmarks.tests import tiny

NV, L, D = 21818, 100, 256


def metric(name):
    return harness.load_metric(name, tiny.ROOT)


def test_b1_count_and_bound():
    ops, n_bytes = metric("b1_roofline_pct").counts(1000, NV, L, D)
    assert ops == 2 * 2 * 1000 * NV * L * D == pytest.approx(2.234e12, rel=1e-3)
    assert n_bytes == 2 * NV * L * D + 2 * 1000 * D + 4 * 1000 * NV
    assert peaks.bound_s(ops, n_bytes, "int8") == pytest.approx(1.1290e-3, rel=1e-3)
    # at 50 queries the cache read bounds it
    ops50, bytes50 = metric("b1_roofline_pct").counts(50, NV, L, D)
    assert peaks.bound_s(ops50, bytes50, "int8") == bytes50 / peaks.PEAK_BYTES_S


def test_b5_count_logical_rows():
    ops, n_bytes = metric("b5_roofline_pct").counts(1000, NV, L, D)
    rows = 2_181_800
    assert ops == 2 * 1000 * rows * 512
    assert n_bytes == rows * 512 + 4 * rows + 1000 * 512 + 4 * 1000 + 2 * 1000 * rows
    assert peaks.bound_s(ops, n_bytes, "int8") == pytest.approx(n_bytes / 3.35e12)


def test_sweep_count():
    ops, n_bytes = metric("sweep_bf16_roofline_pct").counts(1000, NV, L, D)
    assert ops == 2 * 1000 * NV * L * 512
    assert peaks.bound_s(ops, n_bytes, "bf16") == pytest.approx(ops / 989e12)


def test_selection_counts():
    assert metric("b11_roofline_pct").counts(1000, NV, 100, 200) == (
        0.0, 1000 * (4 * NV + 8 * 300))
    assert metric("b6_roofline_pct").counts(1000, 100, 200) == (0.0, 8 * 1000 * 300)


def test_mfu_parts_per_part():
    cfg = tiny.tiny_config("xml_tvr_shipped")
    full = dict(cfg, corpus={"n_videos": NV, "n_clips": L, "clip_length": 1.5})
    full["model"] = dict(cfg["model"], hidden_size=D, query_input_size=768, max_desc_l=30)
    full["retrieval"] = dict(cfg["retrieval"], max_vcmr_video=100)
    lens = [np.full(1000, 20), np.full(1000, 10)]
    p = metric("mfu_pct").parts(full["model"], full["retrieval"], full["semantics"],
                                full["corpus"], 1000, lens)
    t, t2 = 30000, 1000 * (400 + 100)
    assert p["encoder"] == (2 * t * 768 * D + 8 * t * D * D + 4 * t2 * D + 8 * t * D
                            + 2 * 4 * 1000 * D * D, "f32")
    assert p["video_scores"] == (2 * 4 * 1000 * NV * L * D, "int8")
    assert p["span_similarity"] == (2 * 2 * 1000 * 101 * L * 2 * D, "bf16")
    assert p["convse"] == (2 * 4 * 1000 * 101 * L * 5, "f32")
    int8 = metric("mfu_pct").parts(full["model"], full["retrieval"],
                                   {"feat2": "int8_rows"}, full["corpus"], 1000, lens)
    assert int8["span_similarity"][1] == "int8"
    ideal = sum(ops / peaks.PEAK_OPS_S[prec] for ops, prec in p.values()) / 2
    # one call: B1's int8 products (1.129 ms) lead the necessary time
    assert 1.129e-3 < ideal < 1.5e-3


class _FakeTrace:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_s(self, patterns):
        return self.seconds


def test_roofline_share_is_bound_over_time():
    class Run:
        n_calls = 4
        trace = _FakeTrace(4 * 2e-3)
    share = peaks.roofline_pct(Run, ("x",), 1.979e12, 0.0, "int8")
    assert share == pytest.approx(50.0)
    Run.trace = None
    assert peaks.roofline_pct(Run, ("x",), 1.0, 1.0, "int8") is None
    assert math.isclose(peaks.bound_s(0, 3.35e12, "f32"), 1.0)
