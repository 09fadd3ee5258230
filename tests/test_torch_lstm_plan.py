"""Launch plans of the persistent LSTM kernels B1-B4
(``paule_tpu_torch.ops.lstm_kernels``: ``fwd_plan``, ``stack2_plan``,
``bwd_plan``, ``stack2_bwd_plan``).

The kernels run only on the card; their plans are pure Python and are held
here to what the kernels assume: every hidden unit owned by exactly one
block (per layer for B3/B4), a grid that fits one block per SM, and shared
memory (B1/B2: the resident weight slice, the carries and a staged row
chunk) under the card's per-block limit.
"""

import pytest

from paule_tpu_torch.ops import lstm_kernels as K
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: an H100 SXM: 132 SMs, 227 KB of opt-in shared memory per block
N_SM = 132
SMEM = 232_448
F32 = 4

SHAPES = [(720, b) for b in (1, 4, 8, 16, 24)] + [
    (hidden, batch) for hidden in (5, 8, 12, 100) for batch in (1, 3, 13)] + [
    # the somatosensory variant's cp->tube and tube->mel models
    (360, b) for b in (1, 8, 24)] + [
    # the training path: batch 16 at the release widths and the zoo's
    (360, 16), (200, 1), (200, 16), (180, 1), (180, 16)]


def _hp(hidden):
    """H rounded up to a multiple of 4: the kernels' zero-padded rows."""
    return -(-hidden // 4) * 4


def _staged(plan):
    """Rows the staging buffer holds: the chunk rounded up to a whole pass."""
    return -(-plan.chunk // plan.rows) * plan.rows


def _owners(plan, n_blocks, hidden):
    """Block of each unit of one layer, from the blocks' unit ranges."""
    owner = {}
    for blk in range(n_blocks):
        for u in range(blk * plan.units, min((blk + 1) * plan.units, hidden)):
            assert u not in owner
            owner[u] = blk
    return owner


def _check_common(plan, hidden, batch):
    assert 1 <= plan.units <= K.MAX_UNITS
    assert plan.blocks <= N_SM, "one block per SM keeps the grid co-resident"
    assert plan.smem <= SMEM
    assert 1 <= plan.chunk <= batch
    assert plan.rows in K.ROWS_PER_PASS
    assert plan.rows >= min(plan.chunk, K.ROWS_PER_PASS[-1])


def _check_backward(plan, hidden, batch):
    """As :func:`_check_common`, except that a chunk too large for the
    widest pass that fits in shared memory runs as several passes of it."""
    assert 1 <= plan.units <= K.MAX_UNITS
    assert plan.blocks <= N_SM
    assert plan.smem <= SMEM
    assert 1 <= plan.chunk <= batch
    assert plan.rows in K.ROWS_PER_PASS
    widest = max(r for r in K.ROWS_PER_PASS if r <= plan.chunk)
    assert plan.rows >= min(plan.chunk, K.ROWS_PER_PASS[-1]) or (
        plan.rows == widest and plan.chunk % plan.rows == 0)


@pytest.mark.parametrize("hidden,batch", SHAPES)
def test_fwd_plan_covers_every_unit_and_fits(hidden, batch):
    plan = K.fwd_plan(hidden, batch, N_SM, SMEM)
    _check_common(plan, hidden, batch)
    owner = _owners(plan, plan.blocks, hidden)
    assert sorted(owner) == list(range(hidden))
    assert set(owner.values()) == set(range(plan.blocks)), "no idle block"
    assert plan.stages == 0
    w_slice = F32 * plan.units * 4 * _hp(hidden)
    gates = F32 * plan.units * 4 * plan.rows     # prefetched input gates
    assert plan.smem == (w_slice + F32 * plan.units * batch + gates
                         + F32 * _staged(plan) * _hp(hidden))
    assert w_slice + F32 * _hp(hidden) <= SMEM


@pytest.mark.parametrize("hidden,batch", SHAPES)
def test_stack2_plan_covers_every_unit_of_both_layers(hidden, batch):
    plan = K.stack2_plan(hidden, batch, N_SM, SMEM)
    _check_common(plan, hidden, batch)
    assert plan.blocks % 2 == 0
    for _layer in range(2):
        owner = _owners(plan, plan.blocks // 2, hidden)
        assert sorted(owner) == list(range(hidden))
        assert set(owner.values()) == set(range(plan.blocks // 2))
    assert K.MIN_STAGES <= plan.stages <= K.MAX_STAGES
    assert plan.smem == (F32 * plan.units * (batch + 4 * plan.rows)
                         + F32 * _staged(plan) * 2 * _hp(hidden)
                         + plan.stages * plan.units * K.TILE_BYTES)


def test_plans_at_the_main_path_shapes():
    """H=720 on 132 SMs: B1 runs 120 blocks of 6 units holding 69,120 bytes
    of W_hh each; B3 runs 66 blocks per layer; both stage every row of the
    batch at once, up to B=24."""
    for batch in (1, 8, 24):
        b1 = K.fwd_plan(720, batch, N_SM, SMEM)
        assert (b1.blocks, b1.units, b1.chunk) == (120, 6, batch)
        b3 = K.stack2_plan(720, batch, N_SM, SMEM)
        assert (b3.blocks, b3.units, b3.chunk) == (132, 11, batch)
    assert K.fwd_plan(720, 1, N_SM, SMEM).smem - F32 * (6 + 720 + 24) == 69_120


def test_plans_at_the_somatosensory_shapes():
    """The somatosensory variant's shapes on 132 SMs (no plan depends on
    T, so T=402 plans as T=201): B1/B2 at H=360 run 120 blocks of 3 units
    and stage every row up to B=24 (B1) and B=8 (B2) at once; the tube
    embedder's two layers run B1/B2 at H=720, B=1 in train mode and B3 at
    H=720 in eval mode, as the main path's embedder does."""
    for batch in (1, 8, 24):
        b1 = K.fwd_plan(360, batch, N_SM, SMEM)
        assert (b1.blocks, b1.units, b1.chunk, b1.rows) == (120, 3, batch,
                                                            batch)
    for batch in (1, 8):
        b2 = K.bwd_plan(360, batch, N_SM, SMEM)
        assert (b2.blocks, b2.units, b2.chunk, b2.rows) == (120, 3, batch,
                                                            batch)
    assert K.fwd_plan(360, 1, N_SM, SMEM).smem - F32 * (3 + 4 * 3 + 360) == (
        F32 * 3 * 4 * 360)
    assert K.bwd_plan(720, 1, N_SM, SMEM).blocks == 120
    for batch in (1, 24):
        b3 = K.stack2_plan(720, batch, N_SM, SMEM)
        assert (b3.blocks, b3.units, b3.chunk) == (132, 11, batch)
        assert b3.smem <= SMEM


@pytest.mark.parametrize("batch", [8, 16])
def test_stack_plans_at_the_batched_planning_shapes(batch):
    """Batched planning runs B3 and B4 at (201, B) in every inner step,
    for B up to its ``max_batch`` (8 by default): 66 blocks per layer of 11
    units; B3 stages every row of the batch at once, B4 chunks of 4 rows
    (2 or 4 chunks a step), with at least the shortest weight ring."""
    b3 = K.stack2_plan(720, batch, N_SM, SMEM)
    assert (b3.blocks, b3.units, b3.chunk, b3.rows) == (132, 11, batch,
                                                        batch)
    b4 = K.stack2_bwd_plan(720, batch, N_SM, SMEM)
    assert (b4.blocks, b4.units, b4.chunk, b4.rows) == (132, 11, 4, 4)
    for plan in (b3, b4):
        assert K.MIN_STAGES <= plan.stages and plan.smem <= SMEM


def test_plans_at_the_training_shapes():
    """The training path at batch 16 on 132 SMs (no plan depends on T):
    B1 stages all 16 rows at every width; B2 at H=720 stages 8 at a time
    (two chunks), at H=360 all 16; B3 stages all 16 at H=720 beside a ring
    of 6 tiles; B4 at H=720 streams both layers' weights once per chunk of
    4 rows (four chunks); the zoo's H=180 (``SemVecTo*``) and H=200
    (``LSTM*``) pairs run 3 and 4 units per block, the H=200 layers alone
    2."""
    expect = {
        (K.fwd_plan, 720): (120, 6, 16, 16), (K.fwd_plan, 360): (120, 3, 16,
                                                                 16),
        (K.fwd_plan, 200): (100, 2, 16, 16),
        (K.bwd_plan, 720): (120, 6, 8, 8), (K.bwd_plan, 360): (120, 3, 16,
                                                               16),
        (K.bwd_plan, 200): (100, 2, 16, 16),
        (K.stack2_plan, 720): (132, 11, 16, 16),
        (K.stack2_plan, 180): (120, 3, 16, 16),
        (K.stack2_plan, 200): (100, 4, 16, 16),
        (K.stack2_bwd_plan, 720): (132, 11, 4, 4),
        (K.stack2_bwd_plan, 180): (120, 3, 16, 16),
        (K.stack2_bwd_plan, 200): (100, 4, 16, 16),
    }
    for (plan_fn, hidden), want in expect.items():
        plan = plan_fn(hidden, 16, N_SM, SMEM)
        assert (plan.blocks, plan.units, plan.chunk, plan.rows) == want, (
            plan_fn.__name__, hidden)
        assert plan.smem <= SMEM
    assert K.stack2_plan(720, 16, N_SM, SMEM).stages == 6
    assert K.MIN_STAGES <= K.stack2_bwd_plan(720, 16, N_SM, SMEM).stages


def test_large_batches_are_staged_in_chunks():
    """A batch larger than shared memory holds is staged in chunks of whole
    passes, as many as fit."""
    plan = K.fwd_plan(720, 1000, N_SM, SMEM)
    assert plan.chunk < 1000 and plan.chunk % plan.rows == 0
    assert plan.smem <= SMEM < plan.smem + F32 * plan.rows * 720
    plan = K.stack2_plan(720, 1000, N_SM, SMEM)
    assert plan.chunk < 1000 and plan.chunk % plan.rows == 0
    assert plan.stages == K.MIN_STAGES
    assert plan.smem <= SMEM < plan.smem + F32 * plan.rows * 2 * 720


def test_stack2_ring_deepens_as_the_chunk_shrinks():
    """B3 gives what the staged rows leave to each warp's weight ring."""
    stages = [K.stack2_plan(720, b, N_SM, SMEM).stages for b in (1, 8, 24)]
    assert stages == sorted(stages, reverse=True)
    assert stages[0] == K.MAX_STAGES


def test_odd_sm_counts_keep_the_stack_grid_co_resident():
    for n_sm in (121, 125, 127, 131):
        plan = K.stack2_plan(720, 8, n_sm, SMEM)
        assert plan.blocks <= n_sm
        assert plan.blocks // 2 * plan.units >= 720


@pytest.mark.parametrize("plan_fn,hidden,batch,n_sm,match", [
    # B1's weight slice alone exceeds a block's shared memory
    (K.fwd_plan, 1500, 1, N_SM, "no room"),
    # too few SMs: more units per block than the kernel has warps
    (K.fwd_plan, 720, 1, 8, "units per block"),
    (K.stack2_plan, 720, 1, 16, "units per block"),
    (K.stack2_plan, 8, 1, 1, "2 SMs"),
])
def test_plan_raises_when_the_grid_cannot_fit(plan_fn, hidden, batch, n_sm,
                                              match):
    with pytest.raises(ValueError, match=match):
        plan_fn(hidden, batch, n_sm, SMEM)


@pytest.mark.parametrize("hidden,batch", SHAPES)
def test_bwd_plan_covers_every_unit_and_fits(hidden, batch):
    plan = K.bwd_plan(hidden, batch, N_SM, SMEM)
    _check_backward(plan, hidden, batch)
    owner = _owners(plan, plan.blocks, hidden)
    assert sorted(owner) == list(range(hidden))
    assert set(owner.values()) == set(range(plan.blocks)), "no idle block"
    assert plan.stages == 0
    w_rows = F32 * plan.units * 4 * hidden       # W_hh rows, resident
    assert plan.smem == (w_rows
                         + F32 * plan.units * (batch + K.IN_FLOATS * plan.rows)
                         + F32 * _staged(plan) * 4 * hidden)


@pytest.mark.parametrize("hidden,batch", SHAPES)
def test_stack2_bwd_plan_covers_every_unit_of_both_layers(hidden, batch):
    plan = K.stack2_bwd_plan(hidden, batch, N_SM, SMEM)
    _check_backward(plan, hidden, batch)
    assert plan.blocks % 2 == 0
    for _layer in range(2):
        owner = _owners(plan, plan.blocks // 2, hidden)
        assert sorted(owner) == list(range(hidden))
        assert set(owner.values()) == set(range(plan.blocks // 2))
    assert K.MIN_STAGES <= plan.stages <= K.MAX_STAGES
    assert plan.smem == (F32 * plan.units * (batch + K.IN_FLOATS * plan.rows)
                         + F32 * _staged(plan) * 8 * hidden
                         + plan.stages * plan.units * K.TILE_BYTES)


def test_backward_plans_at_the_main_path_shapes():
    """H=720 on 132 SMs: B2 runs 120 blocks of 6 units holding 69,120 bytes
    of W_hh rows each and stages every row of a training batch (B=8) at
    once; B4 runs 66 blocks per layer of 11 units, with the deepest ring at
    B=1 and every row of B=4 in one pass."""
    for batch in (1, 8):
        b2 = K.bwd_plan(720, batch, N_SM, SMEM)
        assert (b2.blocks, b2.units, b2.chunk, b2.rows) == (120, 6, batch,
                                                            batch)
    assert K.bwd_plan(720, 8, N_SM, SMEM).smem == (
        69_120 + F32 * 6 * 8 + F32 * 6 * K.IN_FLOATS * 8 + 8 * 11_520)
    b4 = K.stack2_bwd_plan(720, 1, N_SM, SMEM)
    assert (b4.blocks, b4.units, b4.chunk, b4.rows) == (132, 11, 1, 1)
    assert b4.stages == K.MAX_STAGES
    b4 = K.stack2_bwd_plan(720, 4, N_SM, SMEM)
    assert (b4.chunk, b4.rows) == (4, 4) and b4.stages >= K.MIN_STAGES


@pytest.mark.parametrize("plan_fn,row_floats", [
    (K.bwd_plan, 4 * 720), (K.stack2_bwd_plan, 8 * 720)])
def test_backward_large_batches_are_staged_in_chunks(plan_fn, row_floats):
    """A batch larger than shared memory holds is staged in chunks of whole
    passes, as many rows as fit."""
    plan = plan_fn(720, 1000, N_SM, SMEM)
    assert plan.chunk < 1000 and plan.chunk % plan.rows == 0
    assert plan.smem <= SMEM < plan.smem + F32 * plan.rows * row_floats


def test_odd_sm_counts_keep_the_backward_grids_co_resident():
    for n_sm in (121, 125, 127, 131):
        b2 = K.bwd_plan(720, 8, n_sm, SMEM)
        assert b2.blocks <= n_sm and b2.blocks * b2.units >= 720
        b4 = K.stack2_bwd_plan(720, 1, n_sm, SMEM)
        assert b4.blocks <= n_sm and b4.blocks // 2 * b4.units >= 720
        assert b4.smem <= SMEM


@pytest.mark.parametrize("plan_fn,hidden,n_sm,smem,match", [
    # B2's W_hh rows alone exceed a block's shared memory
    (K.bwd_plan, 1500, N_SM, SMEM, "no room"),
    # B4's shortest rings leave no room for one staged 8H row
    (K.stack2_bwd_plan, 720, N_SM, 60_000, "no room"),
    # too few SMs: more units per block than the kernel has warps
    (K.bwd_plan, 720, 8, SMEM, "units per block"),
    (K.stack2_bwd_plan, 720, 16, SMEM, "units per block"),
    (K.stack2_bwd_plan, 8, 1, SMEM, "2 SMs"),
])
def test_backward_plan_raises_when_the_grid_cannot_fit(plan_fn, hidden, n_sm,
                                                       smem, match):
    with pytest.raises(ValueError, match=match):
        plan_fn(hidden, 1, n_sm, smem)
