"""Launch plans of the ceiling probes P1/P2
(``paule_tpu_torch.tools.kernel_ceiling_probes.probe_plan``).

The probe kernels run only on the card; their plans are pure Python and
are held here to what ``csrc/ceiling_probes.cu`` assumes: every gate column
(``fwd_wide``) or hidden unit (the other three) owned by exactly one block,
a grid of at most one block per SM, the kernel's limits on columns, units
and rows, and dynamic shared memory, recounted here from the kernels'
layouts, under the card's per-block limit.  A width that cannot fit raises
``ValueError``.
"""

import pytest

from paule_tpu_torch.tools import kernel_ceiling_probes as P
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: an H100 SXM: 132 SMs, 227 KB of opt-in shared memory per block
N_SM = 132
SMEM = 232_448
F32 = 4
H = 720


def _round_up(n, m):
    return -(-n // m) * m


def _layout_bytes(kind, plan, hidden, batch):
    """The kernel's dynamic shared memory, region by region."""
    g = 4 * hidden
    if kind == "fwd_wide":
        # w_s (cols x H), pre_s (B x 4H), c_s (B x H), h_s (rows x H)
        floats = (plan.units * hidden + batch * g + batch * hidden
                  + plan.rows * hidden)
    elif kind == "bwd_wide":
        # w_s (units x 4H), a_s (B x 4H), dh_s, dc_s (B x H), red_s
        floats = (plan.units * g + batch * g + 2 * batch * hidden
                  + P.WIDE_WARPS * P.MAX_UNITS * plan.rows)
    else:
        # w_s (units x 4H), x_s (staged rows), c_s (units x B)
        row = hidden if kind == "fwd_split" else g
        floats = (plan.units * g + _round_up(plan.chunk, plan.rows) * row
                  + plan.units * batch)
    return P.HEADER + F32 * floats


def _check_plan(kind, plan, hidden, batch):
    owned = 4 * hidden if kind == "fwd_wide" else hidden
    most = P.MAX_COLS if kind == "fwd_wide" else P.MAX_UNITS
    assert 1 <= plan.units <= most
    assert plan.blocks <= N_SM, "one block per SM keeps the grid co-resident"
    owner = {}
    for blk in range(plan.blocks):
        for x in range(blk * plan.units, min((blk + 1) * plan.units, owned)):
            assert x not in owner
            owner[x] = blk
    assert sorted(owner) == list(range(owned)), "each exactly once"
    assert set(owner.values()) == set(range(plan.blocks)), "no idle block"
    assert plan.rows in P.ROWS_PER_PASS
    if kind.endswith("wide"):
        assert plan.chunk == batch and plan.rows >= batch
    else:
        assert 1 <= plan.chunk <= batch
        widest = max(r for r in P.ROWS_PER_PASS if r <= plan.chunk)
        assert plan.rows >= min(plan.chunk, P.ROWS_PER_PASS[-1]) or (
            plan.rows == widest and plan.chunk % plan.rows == 0)
    assert plan.smem == _layout_bytes(kind, plan, hidden, batch)
    assert plan.smem <= SMEM


@pytest.mark.parametrize("batch", [1, 4, 8, 16])
@pytest.mark.parametrize("kind", P.KINDS)
def test_plan_covers_and_fits_or_raises(kind, batch):
    """At H=720: a returned plan covers every column or unit once and fits;
    the wide forms, which hold the whole batch in one pass, raise above 8
    rows."""
    if kind.endswith("wide") and batch > P.ROWS_PER_PASS[-1]:
        with pytest.raises(ValueError, match="one pass"):
            P.probe_plan(kind, H, batch, N_SM, SMEM)
        return
    plan = P.probe_plan(kind, H, batch, N_SM, SMEM)
    _check_plan(kind, plan, H, batch)


@pytest.mark.parametrize("kind", P.KINDS)
def test_continue_learning_shape_fits_in_one_chunk(kind):
    """(402, 8), continue-learning's B1/B2 shape: every probe holds its
    W_hh share and all 8 rows at once, one block per SM."""
    plan = P.probe_plan(kind, H, 8, N_SM, SMEM)
    _check_plan(kind, plan, H, 8)
    assert plan.chunk == 8 and plan.rows == 8
    assert plan.units == (22 if kind == "fwd_wide" else 6)
    assert plan.blocks == (131 if kind == "fwd_wide" else 120)


def test_split_backward_chunks_rows_at_batch_16():
    """B=16: 16 staged dgates rows (184 KB) beside the W_hh rows (69 KB)
    exceed the limit, so the split backward stages two chunks of 8, as B2
    does; the split forward's h rows fit at once."""
    assert P.probe_plan("bwd_split", H, 16, N_SM, SMEM).chunk == 8
    assert P.probe_plan("fwd_split", H, 16, N_SM, SMEM).chunk == 16


@pytest.mark.parametrize("kind,hidden,batch,n_sm,smem,match", [
    ("fwd_wide", 722, 1, N_SM, SMEM, "multiple of 4"),
    ("bwd_split", 0, 1, N_SM, SMEM, "multiple of 4"),
    ("fwd_wide", H, 9, N_SM, SMEM, "one pass"),
    ("fwd_wide", H, 1, 60, SMEM, "columns per block"),
    ("fwd_split", H, 1, 64, SMEM, "units per block"),
    ("bwd_wide", 800, 1, 132, SMEM, "threads take"),
    ("bwd_wide", H, 8, N_SM, 200_000, "more than 200000"),
    ("fwd_wide", H, 8, N_SM, 150_000, "more than 150000"),
    ("bwd_split", H, 1, N_SM, 60_000, "no room"),
    ("diagonal", H, 1, N_SM, SMEM, "kind"),
])
def test_width_that_cannot_fit_raises(kind, hidden, batch, n_sm, smem,
                                      match):
    with pytest.raises(ValueError, match=match):
        P.probe_plan(kind, hidden, batch, n_sm, smem)


@pytest.mark.parametrize("kind", P.KINDS)
@pytest.mark.parametrize("hidden,batch", [(100, 3), (360, 8), (4, 1)])
def test_other_widths(kind, hidden, batch):
    """Other widths the kernels take: fewer units or columns per block."""
    plan = P.probe_plan(kind, hidden, batch, N_SM, SMEM)
    _check_plan(kind, plan, hidden, batch)
