"""Launch plans of the persistent LSTM kernels B1-B4
(``paule_tpu_torch.ops.lstm_kernels``: ``fwd_plan``, ``stack2_plan``,
``bwd_plan``, ``stack2_bwd_plan``).

The kernels run only on the card; their plans are pure Python and are held
here to what the kernels assume: every hidden unit owned by exactly one
block (per layer for B3/B4), a grid that fits one block per SM, and shared
memory (B1 and B2 below B=8: the resident weight slice, the carries and a
staged row chunk; the tiled B2 from B=8: the weight slice, the ring of
``dgates`` column slots, the slices' sums and the prefetched inputs) under
the card's per-block limit.  The wrapper's choice of B2's layout is held
here too, with its launch stubbed.
"""

import pytest
import torch

from paule_tpu_torch import tracing
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
    B1 stages all 16 rows at every width; the tiled B2 takes all 16 rows in
    one pass (two row groups of 8) at every width; B3 stages all 16 at
    H=720 beside a ring
    of 6 tiles; B4 at H=720 streams both layers' weights once per chunk of
    4 rows (four chunks); the zoo's H=180 (``SemVecTo*``) and H=200
    (``LSTM*``) pairs run 3 and 4 units per block, the H=200 layers alone
    2."""
    expect = {
        (K.fwd_plan, 720): (120, 6, 16, 16), (K.fwd_plan, 360): (120, 3, 16,
                                                                 16),
        (K.fwd_plan, 200): (100, 2, 16, 16),
        (K.bwd_plan, 720): (120, 6, 16, 8), (K.bwd_plan, 360): (120, 3, 16,
                                                               8),
        (K.bwd_plan, 200): (100, 2, 16, 8),
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
    assert [K.bwd_plan(h, 16, N_SM, SMEM).stages for h in (720, 360, 200)] == [
        2, 2, 1]


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


def _tiled_smem(plan, hidden):
    """The tiled B2's shared bytes, from the kernel's layout: w_s (units x
    4H), the ring (stages x alloc x SLOT_COLS), red_s (SLICES x alloc x
    TILED_UNITS), p_s (TILED_UNITS x alloc x IN_FLOATS); alloc = rows x
    row groups."""
    alloc = -(-plan.chunk // plan.rows) * plan.rows
    return F32 * (plan.units * 4 * hidden
                  + plan.stages * alloc * K.SLOT_COLS
                  + K.SLICES * alloc * K.TILED_UNITS
                  + K.TILED_UNITS * alloc * K.IN_FLOATS)


def _check_tiled(plan, hidden, batch):
    """What the tiled kernel assumes of its plan (``tiled_plan_ok``)."""
    assert 1 <= plan.units <= K.MAX_UNITS
    assert plan.blocks <= N_SM
    assert plan.rows == K.TILED_ROWS
    assert 1 <= plan.chunk <= min(batch, K.ROW_GROUPS * plan.rows)
    assert 1 <= plan.stages <= min(K.MAX_STAGES,
                                   -(-4 * hidden // K.SLOT_COLS))
    assert plan.smem == _tiled_smem(plan, hidden) <= SMEM
    # threads: SLICES warps a row group
    assert -(-plan.chunk // plan.rows) * K.SLICES * 32 <= 512


@pytest.mark.parametrize("hidden,batch", SHAPES)
def test_bwd_plan_covers_every_unit_and_fits(hidden, batch):
    plan = K.bwd_plan(hidden, batch, N_SM, SMEM)
    owner = _owners(plan, plan.blocks, hidden)
    assert sorted(owner) == list(range(hidden))
    assert set(owner.values()) == set(range(plan.blocks)), "no idle block"
    if isinstance(plan, K.TiledPlan):
        assert batch >= K.TILED_MIN_BATCH
        _check_tiled(plan, hidden, batch)
        return
    _check_backward(plan, hidden, batch)
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
    of W_hh rows each and takes every row of a training batch (B=8) in one
    pass; B4 runs 66 blocks per layer of 11 units, with the deepest ring at
    B=1 and every row of B=4 in one pass."""
    for batch in (1, 8):
        b2 = K.bwd_plan(720, batch, N_SM, SMEM)
        assert (b2.blocks, b2.units, b2.chunk, b2.rows) == (120, 6, batch,
                                                            batch)
    # the tiled layout at B=8: W_hh rows, all three column slots of 8 rows
    # (4H = 2,880 columns), the slices' sums and the prefetched inputs
    assert K.bwd_plan(720, 8, N_SM, SMEM).smem == (
        69_120 + 3 * F32 * 8 * 1024 + F32 * 8 * 8 * 6 + F32 * 6 * 8 * 6)
    b4 = K.stack2_bwd_plan(720, 1, N_SM, SMEM)
    assert (b4.blocks, b4.units, b4.chunk, b4.rows) == (132, 11, 1, 1)
    assert b4.stages == K.MAX_STAGES
    b4 = K.stack2_bwd_plan(720, 4, N_SM, SMEM)
    assert (b4.chunk, b4.rows) == (4, 4) and b4.stages >= K.MIN_STAGES


@pytest.mark.parametrize("plan_fn,row_floats", [
    (K.bwd_plan, 4 * 720), (K.stack2_bwd_plan, 8 * 720)])
def test_backward_large_batches_are_staged_in_chunks(plan_fn, row_floats):
    """A batch larger than shared memory holds is staged in chunks of whole
    passes: B4 as many rows as fit, the tiled B2 a pass of all its row
    groups."""
    plan = plan_fn(720, 1000, N_SM, SMEM)
    assert plan.chunk < 1000 and plan.chunk % plan.rows == 0
    if plan_fn is K.bwd_plan:
        assert plan.chunk == K.ROW_GROUPS * plan.rows
        assert plan.smem <= SMEM < plan.smem + F32 * plan.chunk * K.SLOT_COLS
    else:
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


@pytest.mark.parametrize("hidden", [720, 360, 200])
@pytest.mark.parametrize("batch", [4, 8, 16, 24])
def test_tiled_bwd_plan_covers_units_and_columns(hidden, batch):
    """B2 at the widths of the main path, the tube models and the zoo:
    below B=8 the owner layout; from B=8 the tiled one, with every unit
    owned by one block and by one pass of it (up to TILED_UNITS units a
    pass), every row by one pass and row group, every column of the 4H
    reduction axis by exactly one (slot, slice, lane), and the shared bytes
    of the kernel's layout under the limit."""
    plan = K.bwd_plan(hidden, batch, N_SM, SMEM)
    if batch < K.TILED_MIN_BATCH:
        assert not isinstance(plan, K.TiledPlan)
        _check_backward(plan, hidden, batch)
        return
    assert isinstance(plan, K.TiledPlan)
    _check_tiled(plan, hidden, batch)
    owner = _owners(plan, plan.blocks, hidden)
    assert sorted(owner) == list(range(hidden))
    passes = {}
    for blk in range(plan.blocks):
        own = min(plan.units, hidden - blk * plan.units)
        for j0 in range(0, own, K.TILED_UNITS):
            for j in range(j0, min(own, j0 + K.TILED_UNITS)):
                u = blk * plan.units + j
                assert u not in passes
                passes[u] = j0
    assert sorted(passes) == list(range(hidden))
    rows = [b0 + r for b0 in range(0, batch, plan.chunk)
            for r in range(min(plan.chunk, batch - b0))]
    assert rows == list(range(batch))
    g = 4 * hidden
    seen = []
    for s in range(-(-g // K.SLOT_COLS)):
        for sl in range(K.SLICES):
            for lane in range(32):
                k = s * K.SLOT_COLS + sl * 128 + 4 * lane
                if k < g:
                    seen.extend(range(k, k + 4))
    assert sorted(seen) == list(range(g))


@pytest.mark.parametrize("hidden", [720, 360])
def test_odd_sm_counts_keep_the_tiled_grid_co_resident(hidden):
    for n_sm in (121, 125, 127, 131):
        for batch in (8, 13, 16):
            plan = K.bwd_plan(hidden, batch, n_sm, SMEM)
            assert isinstance(plan, K.TiledPlan)
            assert plan.blocks <= n_sm
            assert plan.blocks * plan.units >= hidden
            assert (plan.blocks - 1) * plan.units < hidden
            assert plan.smem == _tiled_smem(plan, hidden) <= SMEM


@pytest.mark.parametrize("hidden,want", [
    (720, (120, 6, 1, 1, 0, 80_808)), (360, (120, 3, 1, 1, 0, 23_124)),
    (200, (100, 2, 1, 1, 0, 9_656)), (100, (100, 1, 1, 1, 0, 3_228)),
    (180, (90, 2, 1, 1, 0, 8_696))])
def test_bwd_plan_at_one_row_is_the_owner_plan(hidden, want):
    """Below B=8 B2 keeps its owner layout and the plan it had before the
    tiled layout came: pinned at B=1; at B=2-7 the owner layout's plan
    (rows of 4 or 8 a pass)."""
    assert tuple(K.bwd_plan(hidden, 1, N_SM, SMEM)) == want
    for batch in range(1, K.TILED_MIN_BATCH):
        plan = K.bwd_plan(hidden, batch, N_SM, SMEM)
        assert not isinstance(plan, K.TiledPlan)
        assert plan == K._one_layer_plan("B2", hidden, batch, N_SM, SMEM,
                                         4 * hidden, K.IN_FLOATS,
                                         4 * hidden)
        assert plan.rows in (1, 4, 8)


@pytest.mark.parametrize("n_sm,smem", [(N_SM, SMEM), (121, SMEM),
                                       (66, SMEM), (N_SM, 101_376)])
def test_tiled_plan_accepts_every_shape_the_owner_plan_accepted(n_sm, smem):
    """Wherever the owner layout's plan (the only one before the tiled
    layout) had a plan, B2 still has one: the tiled layout's from B=8 on
    where its ring fits (it does at every width up to 792 on 132 SMs),
    else the owner layout's, with no more than 8 rows a pass, which the
    kernel is built for."""
    def owner(hidden, batch):
        return K._one_layer_plan("B2", hidden, batch, n_sm, smem, 4 * hidden,
                                 K.IN_FLOATS, 4 * hidden)

    accepted = 0
    for hidden in range(1, 1600, 7):
        for batch in (2, 3, 4, 5, 8, 13, 16, 24, 100, 1000, 6000):
            try:
                owner(hidden, batch)
            except ValueError:
                continue
            accepted += 1
            plan = K.bwd_plan(hidden, batch, n_sm, smem)
            assert plan.blocks <= n_sm and plan.smem <= smem
            if isinstance(plan, K.TiledPlan):
                assert plan.smem == _tiled_smem(plan, hidden)
            else:
                assert plan.rows <= 8
                assert (batch < K.TILED_MIN_BATCH
                        or K.bwd_tiled_plan(hidden, batch, n_sm, smem) is None)
                assert not (n_sm == N_SM and smem == SMEM and hidden <= 792
                            and batch >= K.TILED_MIN_BATCH)
    assert accepted > 100


def test_the_wrapper_picks_the_layout_from_the_batch(monkeypatch):
    """Off the CPU, B2's wrapper launches the owner layout below B=8 and
    the tiled one from B=8, each with the plan of its layout, and counts
    the tiled launches (``lstm_bwd.tiled``; in a traced call also the
    ``lstm_bwd_tiled`` counter), with the launch stubbed."""
    launched = []
    monkeypatch.setattr(K, "device_limits", lambda index: (N_SM, SMEM))
    monkeypatch.setattr(K, "_launch", lambda name, dev, tensors, ints,
                        events=None: launched.append((name, ints)))
    monkeypatch.setattr(tracing, "op_events", lambda dev: (None, None))
    f32 = dict(device="meta", dtype=torch.float32)

    def bwd(seq, batch, hidden):
        return K.lstm_bwd(torch.empty(seq, batch, 4 * hidden, **f32),
                          torch.empty(seq, batch, hidden, **f32),
                          torch.empty(seq, batch, hidden, **f32),
                          torch.empty(hidden, 4 * hidden, **f32))

    K.reset_launch_counts()
    shapes = [(5, 1, 720), (5, 4, 720), (5, 16, 720), (5, 1, 360),
              (5, 8, 360), (5, 2, 200)]
    with tracing.call("test", force=True) as rec:
        for shape in shapes:
            bwd(*shape)
    assert [name for name, _ in launched] == [
        "paule_lstm_bwd", "paule_lstm_bwd", "paule_lstm_bwd_tiled",
        "paule_lstm_bwd", "paule_lstm_bwd_tiled", "paule_lstm_bwd"]
    for (name, ints), (seq, batch, hidden) in zip(launched, shapes):
        assert ints == (seq, batch, hidden,
                        *K.bwd_plan(hidden, batch, N_SM, SMEM))
    assert K.lstm_bwd.launches == 6 and K.lstm_bwd.tiled == 2
    assert rec.record["counters"]["lstm_bwd_tiled"] == 2
    bwd(5, 8, 720)                       # untraced: the plain count only
    assert K.lstm_bwd.tiled == 3
    K.reset_launch_counts()
    assert K.lstm_bwd.tiled == 0


def test_the_layout_tool_covers_both_layouts_on_an_h100():
    """``tools.bwd_layouts`` times B2 where each layout runs on a 132-SM
    card (the smoke's shapes among them), and builds the source it is
    compared with into a library of its own."""
    from paule_tpu_torch.tools import bwd_layouts as BL

    tiled = {shape: isinstance(K.bwd_plan(shape[2], shape[1], N_SM, SMEM),
                               K.TiledPlan) for shape in BL.SHAPES}
    assert set(BL.SMOKE_SHAPES) <= set(BL.SHAPES)
    assert all(t == (shape[1] >= K.TILED_MIN_BATCH)
               for shape, t in tiled.items())
    assert {tiled[s] for s in BL.SMOKE_SHAPES} == {True, False}
    other = BL.other_library(K.LIBRARY.source)
    assert other.source == K.LIBRARY.source
    assert other.lib_path != K.LIBRARY.lib_path
