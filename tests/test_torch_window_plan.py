"""K10's launch planning on the CPU (tidb_tpu_torch/ops/kernels/
window_scan.py): the lane groups, the lanes an argument shares, the
launches a call makes, the workspace and status layouts and the by-value
header csrc/window_scan.cu reads.  The kernel itself runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py); its plain version is held to
the reference in tests/test_torch_window.py.
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.ops.kernels import window_scan as ws

#: chip_smoke.py's W2 and W4 as device_window hands them to K10 (an AVG is
#: a SUM and a COUNT of one argument)
W2_FUNCS = [("row_number", None), ("rank", None), ("sum", 0), ("count", 1)]
W4_FUNCS = [("dense_rank", None), ("percent_rank", None),
            ("cume_dist", None), ("sum", 0), ("count", 0), ("min", 1),
            ("max", 2), ("sum", 3)]


def _lane_kinds(g):
    return sorted((src, a) for _op, src, a in g.lanes)


def test_w2_is_one_group_of_three_lanes():
    (g,) = ws.lane_groups(W2_FUNCS, [False, False])
    assert g.args == [0, 1]
    assert _lane_kinds(g) == [(ws._VALID, 0), (ws._VALID, 1), (ws._ARG, 0)]
    assert g.smem == ws.TILE * (8 + 2 * 2)
    assert g.need_pe and not g.need_ep
    assert ws.launch_plan(1 << 23, [g])["launches"] == 2


def test_w4_is_one_group_within_shared_memory():
    (g,) = ws.lane_groups(W4_FUNCS, [False, False, False, True])
    # dense_rank's peer count, a count and a value lane per argument
    assert len(g.lanes) == 9 and g.n_val == 4
    assert g.smem == ws.TILE * (4 * 8 + 5 * 2) <= ws.SMEM_MAX
    assert g.need_pe and g.need_ep
    ops = {a: op for op, src, a in g.lanes if src == ws._ARG}
    assert ops == {0: ws._ADD_I, 1: ws._MIN_I, 2: ws._MAX_I, 3: ws._ADD_F}
    plan = ws.launch_plan(1 << 23, [g])
    assert plan["launches"] == 2 and plan["n_tiles"] == (1 << 23) // ws.TILE


def test_an_argument_is_gathered_once_for_all_its_lanes():
    funcs = [("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("sum", 0)]
    (g,) = ws.lane_groups(funcs, [True])
    assert g.args == [0]
    assert [(op, src) for op, src, _a in g.lanes] == [
        (ws._ADD_I, ws._VALID), (ws._ADD_F, ws._ARG), (ws._MIN_F, ws._ARG),
        (ws._MAX_F, ws._ARG)]
    # both sums read the one lane, every function the one count
    by_func = {fi: (cnt, val) for fi, _code, cnt, val in g.funcs}
    assert by_func == {0: (0, -1), 1: (0, 1), 2: (0, 2), 3: (0, 3),
                       4: (0, 1)}
    assert [g.slot(ln) for ln in range(4)] == [0, 0, 1, 2]


def test_a_count_alone_reads_no_data():
    d = torch.arange(8, dtype=torch.int64)
    nl = torch.zeros(8, dtype=torch.bool)
    args = [(d, nl), (d.clone(), nl.clone())]
    (g,) = ws.lane_groups([("count", 0), ("sum", 1)], [False, False])
    packed = ws.pack_group(g, args, 0, ws.output_layout([g])["ncol"][0])
    (d0, n0), (d1, n1) = packed["args"]
    assert d0 == 0 and n0 == nl.data_ptr()
    assert d1 == args[1][0].data_ptr() and n1 == args[1][1].data_ptr()


def test_columns_follow_where_a_function_ends():
    """W4's functions as columns: SUM / MIN / MAX first (their NULL
    flags are one word a row), then what the scan finishes where the row
    is, COUNT, and last what waits on a partition's end."""
    (g,) = ws.lane_groups(W4_FUNCS, [False, False, False, True])
    assert [W4_FUNCS[fi][0] for fi, *_r in g.funcs] == [
        "sum", "min", "max", "sum", "dense_rank", "count", "percent_rank",
        "cume_dist"]
    lay = ws.output_layout([g])
    assert (lay["col0"], lay["n_data"], lay["n_null"]) == ([0], 8, 4)
    assert lay["ncol"] == [[0, 1, 2, 3, -1, -1, -1, -1]] and lay["zero"]


@pytest.mark.parametrize("funcs, col0, n_data, n_null, zero", [
    ([("row_number", None)], [0], 1, 0, True),
    ([("sum", 0), ("count", 0)], [0], 2, 1, True),
    (W2_FUNCS, [0], 4, 1, True),
    ([("sum", 0)] * 3, [0], 4, 4, False),
    ([("min", 0)] * 5 + [("rank", None)] * 4, [0], 12, 8, True),
    ([("max", 0)] * 17, [0], 20, 32, False),
    ([("row_number", None)] * 33, [0, 24], 36, 0, True),
])
def test_output_layout(funcs, col0, n_data, n_null, zero):
    """A group's first int64 column is a multiple of 4 (four values a
    32-byte sector), and a window of one or two functions has only their
    columns; only SUM / MIN / MAX have NULL columns, a row's never
    straddling a sector; the rest share one all-zero array."""
    lay = ws.output_layout(ws.lane_groups(funcs, [False]))
    assert (lay["col0"], lay["n_data"], lay["n_null"], lay["zero"]) == (
        col0, n_data, n_null, zero)
    flat = [c for cols in lay["ncol"] for c in cols]
    nullable = [c for c in flat if c >= 0]
    assert nullable == list(range(len(nullable)))


@pytest.mark.parametrize("n_args", [6, 7, 12])
def test_wide_windows_split_into_groups(n_args):
    funcs = [f for a in range(n_args) for f in (("sum", a), ("max", a))]
    funcs += [("row_number", None), ("dense_rank", None)]
    groups = ws.lane_groups(funcs, [a % 2 == 0 for a in range(n_args)])
    seen = sorted(fi for g in groups for fi, *_r in g.funcs)
    assert seen == list(range(len(funcs)))
    for g in groups:
        assert g.smem <= ws.SMEM_MAX
        assert len(g.lanes) <= ws.MAX_LANES and len(g.args) <= ws.MAX_ARGS
        for fi, _code, cnt, val in g.funcs:
            name, a = funcs[fi]
            if a is not None:  # an argument's lanes live in its group
                assert g.lanes[cnt] == (ws._ADD_I, ws._VALID, a)
                assert g.lanes[val][1:] == (ws._ARG, a)
    need = n_args * ws.TILE * (2 * 8 + 2) + 2 * ws.TILE
    assert len(groups) >= max(-(-need // ws.SMEM_MAX), 2)
    assert ws.launch_plan(1 << 20, groups)["launches"] == 2 * len(groups)


def test_many_functions_split_by_function_count():
    funcs = [("row_number", None)] * (ws.MAX_FUNCS + 5)
    groups = ws.lane_groups(funcs, [])
    assert [len(g.funcs) for g in groups] == [ws.MAX_FUNCS, 5]
    assert all(not g.lanes for g in groups)
    # nothing reads a frame end: one scan a group, no tail
    assert ws.launch_plan(1 << 20, groups)["launches"] == 2


def test_lane_columns_number_across_groups():
    funcs = [("dense_rank", None)] + [("sum", a) for a in range(8)]
    groups = ws.lane_groups(funcs, [True] * 8)
    cols = ws.lane_columns(groups)
    flat = [c for gc in cols for c in gc]
    assert flat.count(-1) == 1  # dense_rank's lane keeps no values
    kept = [c for c in flat if c >= 0]
    assert kept == list(range(len(kept))) and len(kept) == 16


@pytest.mark.parametrize("nb, funcs, launches", [
    (ws.TILE, W4_FUNCS, 1),              # one tile: every frame ends in it
    (ws.TILE + 1, W4_FUNCS, 2),
    (1 << 23, [("row_number", None), ("rank", None)], 1),
    (1 << 23, [("percent_rank", None)], 2),
])
def test_launch_plan(nb, funcs, launches):
    groups = ws.lane_groups(funcs, [False] * 4)
    assert ws.launch_plan(nb, groups)["launches"] == launches


@pytest.mark.parametrize("nb, need_ep", [(100, True), (ws.TILE * 3 + 5, True),
                                         (ws.TILE * 3 + 5, False)])
def test_workspace_layout(nb, need_ep):
    regions, total = ws.workspace_layout(nb, 5, need_ep)
    n_tiles = -(-nb // ws.TILE)
    assert regions["rec"][1] == n_tiles * ws.REC
    assert regions["head"][1] == regions["tail"][1] == n_tiles * 5
    per_row = nb if need_ep and n_tiles > 1 else 0
    assert regions["wpp"][1] == regions["wpe"][1] == per_row
    ends = 0
    for off, size in sorted(regions.values()):
        assert off % 32 == 0 and off >= ends
        ends = off + size
    assert total >= ends


def test_status_layout():
    lay = ws.status_layout(10)
    assert (lay["ctr"], lay["flag"], lay["agg"]) == (0, 1, 11)
    assert lay["incl"] == 11 + 10 * ws.REC_W
    assert lay["words"] == lay["incl"] + 10 * ws.REC_W


def test_pack_header_layout():
    (g,) = ws.lane_groups(W2_FUNCS, [False, False])
    cols = ws.lane_columns([g])
    nb = 5000
    d = torch.zeros(nb, dtype=torch.int64)
    nl = torch.zeros(nb, dtype=torch.bool)
    args = [(d, nl), (d.clone(), nl.clone())]
    lay = ws.output_layout([g])
    packed = [ws.pack_group(g, args, 0, lay["ncol"][0])]
    keys = [(11, 12), (13, 14)]
    hdr = ws.pack_header(nb, 4000, 99, keys, 0b10, 1, packed, cols,
                         [1, 2, 3, 4], 7, [5, 6, 8, 3, 9, 10],
                         [15, 16, 4, 1, 17])
    assert hdr.dtype == np.int64
    assert len(hdr) == ws.HDR_GROUPS + ws.HDR_GROUP
    assert list(hdr[:ws.HDR_KEYS]) == [nb, 4000, 99, 1, 2, 0b10,
                                       -(-nb // ws.TILE), 1,
                                       1, 2, 3, 4, 7, 5, 6, 8, 3, 9, 10,
                                       15, 16, 4, 1, 17]
    assert list(hdr[ws.HDR_KEYS:ws.HDR_KEYS + 4]) == [11, 12, 13, 14]
    h = ws.HDR_GROUPS
    assert list(hdr[h:h + 8]) == [2, 3, 1, 4, 1, 0, g.smem, 0]
    ha = h + 8
    assert list(hdr[ha:ha + 4]) == [args[0][0].data_ptr(),
                                    args[0][1].data_ptr(), 0,
                                    args[1][1].data_ptr()]
    hl = ha + 2 * ws.MAX_ARGS
    lanes = [tuple(hdr[hl + 5 * i:hl + 5 * i + 5]) for i in range(3)]
    assert [ln[4] for ln in lanes] == cols[0]
    hf = hl + 5 * ws.MAX_LANES
    funcs = [tuple(hdr[hf + 4 * i:hf + 4 * i + 4]) for i in range(4)]
    assert funcs == [f[1:] + (nc,) for f, nc in zip(g.funcs,
                                                    lay["ncol"][0])]
    assert sorted(f[0] for f in funcs) == sorted(
        ws.FUNC_CODES[n] for n, _a in W2_FUNCS)
    assert hf + 4 * ws.MAX_FUNCS == ws.HDR_GROUPS + ws.HDR_GROUP


def test_outputs_are_columns_of_the_buffers():
    d = torch.zeros(4, dtype=torch.float64)
    nl = torch.zeros(4, dtype=torch.bool)
    funcs = [("cume_dist", None), ("rank", None), ("sum", 0), ("count", 0)]
    groups = ws.lane_groups(funcs, [True])
    lay = ws.output_layout(groups)
    outs, out_i, out_b, zero = ws._outputs(funcs, [(d, nl)], 4,
                                           torch.device("cpu"), lay, groups)
    assert [o[0].dtype for o in outs] == [torch.float64, torch.int64,
                                          torch.float64, torch.int64]
    assert out_i.shape == (4, 4) and out_b.shape == (4, 1)
    assert zero.shape == (4,)
    # the sum first, cume_dist (a partition's end) last
    assert outs[2][0].data_ptr() == out_i[:, 0].data_ptr()
    assert outs[0][0].data_ptr() == out_i[:, 3].data_ptr()
    for fi, (data, nulls) in enumerate(outs):
        assert data.shape == nulls.shape == (4,) and data.stride() == (4,)
        assert data.untyped_storage().data_ptr() == out_i.data_ptr()
        want = out_b if funcs[fi][0] == "sum" else zero
        assert nulls.data_ptr() == want.data_ptr()
