"""The port's decode attention against the JAX Pallas kernel (interpret mode).

On the CPU the port's wrapper runs its plain PyTorch version; both it and
the plain version are held against ``consensus_tpu.ops.decode_attention``
run with ``interpret=True``, on the cases of tests/test_decode_attention.py
plus a trunk whose width is not a block multiple.  Tolerance: 2e-5 absolute
in float32 (the JAX suite's own bound; the two sides sum in different
orders).  The CUDA kernel is held against the plain version on the card by
the ``cuda`` test below and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.ops.decode_attention import decode_attention as jax_decode
from consensus_tpu_torch.ops import decode_attention as da

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 2e-5


def _inputs(seed, n_slots, n_roles, kv=2, reps=2, hd=128, w0=96, ts=16):
    rng = np.random.default_rng(seed)
    rows = n_slots * n_roles
    q = rng.standard_normal((rows, kv * reps, hd), dtype=np.float32)
    trunk_k = rng.standard_normal((n_roles, w0, kv, hd), dtype=np.float32)
    trunk_v = rng.standard_normal((n_roles, w0, kv, hd), dtype=np.float32)
    tail_k = rng.standard_normal((rows, ts, kv, hd), dtype=np.float32)
    tail_v = rng.standard_normal((rows, ts, kv, hd), dtype=np.float32)
    return q, trunk_k, trunk_v, tail_k, tail_v


def _both(arrays, starts, qpos, write_col, n_slots, n_roles, scale, block_k=64, **kw):
    ref = jax_decode(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(starts, jnp.int32),
        jnp.asarray(qpos, jnp.int32), jnp.asarray(write_col, jnp.int32),
        n_slots=n_slots, n_roles=n_roles, scale=scale, block_k=block_k,
        interpret=True, **kw,
    )
    args = [torch.from_numpy(a) for a in arrays]
    sts = torch.tensor(starts, dtype=torch.int32)
    qps = torch.full((n_roles,), qpos, dtype=torch.int32)
    wrapped = da.decode_attention(*args, sts, qps, write_col, n_slots, n_roles, scale, **kw)
    plain = da.decode_attention_reference(*args, sts, qps, write_col, n_slots, n_roles, scale, **kw)
    return np.asarray(ref), wrapped.numpy(), plain.numpy()


def _check(ref, *outs):
    for out in outs:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("softcap,window", [(None, None), (50.0, None), (50.0, 48), (None, 24)])
def test_matches_jax_kernel(softcap, window):
    arrays = _inputs(0, n_slots=3, n_roles=2)
    _check(*_both(arrays, [5, 17], 101, 7, 3, 2, 0.088, softcap=softcap, window=window))


def test_first_step_write_col_zero():
    """write_col=0: only the current token's own tail column is visible."""
    arrays = _inputs(1, n_slots=2, n_roles=3, w0=64, ts=8)
    _check(*_both(arrays, [0, 9, 30], 63, 0, 2, 3, 0.1, block_k=32))


def test_single_slot_trunk_session():
    """Lookahead trunk sessions: n_slots=1."""
    arrays = _inputs(2, n_slots=1, n_roles=3, w0=128, ts=32)
    _check(*_both(arrays, [2, 0, 64], 140, 12, 1, 3, 0.0884, softcap=30.0, window=96))


def test_trunk_not_a_block_multiple():
    """W0=100 against 64-key blocks; one role's span is its last column."""
    arrays = _inputs(3, n_slots=2, n_roles=3, w0=100, ts=12)
    ref, wrapped, plain = _both(arrays, [99, 40, 0], 110, 5, 2, 3, 0.09)
    _check(ref, wrapped, plain)


def test_gqa_wide_group():
    """Four query heads per kv head, four slots (the llama3-8b grouping)."""
    arrays = _inputs(4, n_slots=4, n_roles=2, kv=1, reps=4, w0=80, ts=10)
    _check(*_both(arrays, [30, 3], 60, 9, 4, 2, 0.0884))


def test_more_than_32_rows_per_group():
    """Nine slots of four query heads per kv head: 36 rows per (role, kv
    head), which the JAX kernel pads to 40; the port's kernel holds them in
    one block's four 16-row tiles, the last part padding (a block holds
    whole slots, at most 64 rows; more slots take more row blocks)."""
    arrays = _inputs(8, n_slots=9, n_roles=2, kv=1, reps=4, w0=80, ts=10)
    _check(*_both(arrays, [30, 3], 60, 9, 9, 2, 0.0884))


def test_cuda_input_check_accepts_wide_groups():
    """The wrapper's checks for the kernel take 64 query rows per (role, kv
    head): 16 slots x 4 heads per kv head, bf16, head_dim 128."""
    rng = np.random.default_rng(9)
    n_slots, n_roles, kv, reps, hd = 16, 2, 2, 4, 128

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)

    rows = n_slots * n_roles
    q, tk, tv = bf16(rows, kv * reps, hd), bf16(n_roles, 32, kv, hd), bf16(n_roles, 32, kv, hd)
    lk, lv = bf16(rows, 8, kv, hd), bf16(rows, 8, kv, hd)
    da._check_shapes(q, tk, tv, lk, lv, n_slots, n_roles)
    da._check_cuda_inputs(q, tk, tv, lk, lv)


def test_empty_trunk_span_sees_only_its_tail_column():
    """A role whose trunk span is empty, under a window of 1, attends only
    its own tail column 0: the output is that column's value, exactly."""
    q, tk, tv, lk, lv = (torch.from_numpy(a) for a in _inputs(5, n_slots=1, n_roles=2, w0=16, ts=4))
    out = da.decode_attention_reference(
        q, tk, tv, lk, lv, torch.tensor([16, 0]), torch.tensor([100, 100]), 0, 1, 2, 0.1,
        window=1,
    )
    assert torch.isfinite(out).all()
    one_key = da.decode_attention_reference(
        q[:1], tk[:1], tv[:1], lk[:1], lv[:1], torch.tensor([16]), torch.tensor([100]), 0, 1, 1,
        0.1,
    )
    torch.testing.assert_close(out[:1], one_key, atol=1e-6, rtol=0)
    torch.testing.assert_close(out[0], lv[0, 0].repeat_interleave(2, dim=0), atol=1e-6, rtol=0)


def test_cpu_wrapper_does_not_count_launches():
    before = da.launches.count
    arrays = [torch.from_numpy(a) for a in _inputs(6, n_slots=1, n_roles=2)]
    da.decode_attention(*arrays, torch.tensor([0, 3]), torch.tensor([99, 96]), 2, 1, 2, 0.1)
    assert da.launches.count == before


def test_shape_mismatch_raises():
    q, tk, tv, lk, lv = (torch.from_numpy(a) for a in _inputs(7, n_slots=2, n_roles=2))
    with pytest.raises(ValueError, match="slots"):
        da.decode_attention(q, tk, tv, lk, lv, torch.zeros(2), torch.zeros(2), 0, 3, 2, 0.1)


#: The kernel's path shapes, for the split sizing: (P, R, H, KV, hd, W0, Ts,
#: write_col, starts, window).  Starts as the paths give them (the llama3-8b
#: beam's prompts cut into W0=1024; classic rows start at 0).
_BEAM_STARTS = [200, 560, 604, 590, 615, 600]
PLAN_SHAPES = {
    "gemma2-2b classic decode": (1, 8, 8, 4, 256, 1024, 32, 31, [0] * 8, 4096),
    "llama3-8b shared trunk, write_col 0": (8, 1, 32, 8, 128, 1024, 256, 0, [0], None),
    "llama3-8b shared trunk, write_col 128": (8, 1, 32, 8, 128, 1024, 256, 128, [0], None),
    "llama3-8b shared trunk, write_col 255": (8, 1, 32, 8, 128, 1024, 256, 255, [0], None),
    "gemma2-2b MCTS trunk advance": (1, 5, 8, 4, 256, 1024, 8, 5, _BEAM_STARTS[:5], 4096),
    "gemma2-2b checkpoint classic": (1, 8, 8, 4, 256, 128, 32, 31, [0] * 8, 4096),
    "tp rank, one head": (1, 8, 1, 1, 256, 128, 32, 31, [0] * 8, None),
    "llama3-8b beam": (4, 6, 32, 8, 128, 1024, 200, 100, _BEAM_STARTS, None),
    "llama3-8b serving cohort": (1, 16, 32, 8, 128, 1024, 64, 38, [0] * 8 + [300] + [0] * 7,
                                 None),
    "W0=700, one role's span one column": (4, 3, 32, 8, 128, 700, 50, 37, [0, 350, 699], None),
    "llama3-8b, 16 slots": (16, 6, 32, 8, 128, 1024, 200, 150, _BEAM_STARTS, None),
    "gemma2-9b, 16 slots, window 256": (16, 6, 16, 8, 256, 1024, 200, 150, _BEAM_STARTS, 256),
    "llama3-8b, 32 slots (two row blocks)": (32, 2, 32, 8, 128, 1024, 64, 40, [0, 900], None),
    "empty trunk spans, write_col 0": (1, 6, 32, 8, 128, 1024, 200, 0, [1024] * 6, None),
}
SMS = 132  # an H100 SXM's streaming multiprocessors


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_split_covers_every_valid_key_once(name):
    """The blocks of each (role, kv head, row block) cluster walk every key
    the masks keep exactly once -- each role's trunk span for all its rows,
    each slot's tail columns for that slot's rows -- and every slot lies in
    exactly one row block."""
    n_slots, n_roles, heads, kv, hd, w0, ts, write_col, starts, window = PLAN_SHAPES[name]
    plan = da.launch_plan(n_slots, n_roles, heads, kv, hd, w0, write_col, SMS)
    qpos = [w0 - s + write_col for s in starts]
    trunk_ok, tail_ok = da._masks(torch.tensor(starts), torch.tensor(qpos), write_col, w0, ts,
                                  window, "cpu")
    for r in range(n_roles):
        slots_seen = []
        trunk_keys = []
        tail_keys = {}
        for z in range(plan.row_blocks):
            units = da.split_units(plan, n_slots, heads // kv, hd, w0, starts[r], qpos[r],
                                   write_col, window, row_block=z)
            assert len(units) == plan.splits
            block_slots = range(z * plan.slots_per_block,
                                min(n_slots, (z + 1) * plan.slots_per_block))
            slots_seen += list(block_slots)
            for split in units:
                for slot, lo, hi in split:
                    assert 0 < hi - lo <= da.STAGE_KEYS[hd]
                    if slot is None:
                        if z == 0:
                            trunk_keys += list(range(lo, hi))
                    else:
                        assert slot in block_slots
                        tail_keys.setdefault(slot, []).extend(range(lo, hi))
        assert slots_seen == list(range(n_slots))
        assert sorted(trunk_keys) == torch.nonzero(trunk_ok[r]).flatten().tolist()
        assert len(set(trunk_keys)) == len(trunk_keys)
        for slot in range(n_slots):
            assert sorted(tail_keys[slot]) == torch.nonzero(tail_ok).flatten().tolist()


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_split_stays_within_the_cluster_and_grid_limits(name):
    """A cluster of at most 8 blocks (the portable size), no more splits
    than a group has key tiles, a block's rows within its 64, grid y and z
    within CUDA's 65535, and a split that costs no more (waves times a
    block's tiles and fixed time) than one block a group."""
    n_slots, n_roles, heads, kv, hd, w0, ts, write_col, starts, window = PLAN_SHAPES[name]
    plan = da.launch_plan(n_slots, n_roles, heads, kv, hd, w0, write_col, SMS)
    x, y, z = plan.grid(n_roles, kv)
    assert 1 <= x == plan.splits <= da.MAX_SPLITS
    assert y == n_roles * kv <= da.MAX_GRID_YZ and 1 <= z <= da.MAX_GRID_YZ
    assert plan.slots_per_block * (heads // kv) <= da.BLOCK_ROWS
    assert plan.row_blocks == -(-n_slots // plan.slots_per_block)
    keys = da.STAGE_KEYS[hd]
    tiles = -(-w0 // keys) + plan.slots_per_block * -(-(write_col + 1) // keys)
    assert plan.splits <= tiles
    groups = y * z

    def cost(splits):
        return -(-groups // (SMS // splits)) * (-(-tiles // splits) + da.FIXED_TILES)

    assert cost(x) == min(cost(s) for s in range(1, min(da.MAX_SPLITS, tiles) + 1)) <= cost(1)
    assert da.launch_plan(n_slots, n_roles, heads, kv, hd, w0, write_col, SMS,
                          max_splits=8).splits <= 8


def test_split_fills_a_card_of_few_groups():
    """The llama3-8b shared trunk has 8 groups: clusters of 8 put 64 blocks
    on the card, where one block a group would leave 124 SMs idle."""
    plan = da.launch_plan(8, 1, 32, 8, 128, 1024, 0, SMS)
    assert plan == da.LaunchPlan(splits=8, slots_per_block=8, row_blocks=1)


def test_split_keeps_every_cluster_in_one_wave():
    """A card that holds 30 clusters of 4 (GPCs whose SMs are no multiple
    of 4): gemma2-2b's 32 classic-decode groups take clusters of 3, all
    resident at once, rather than 4 in two waves."""
    capacity = (132, 66, 44, 30, 24, 20, 16, 16)
    plan = da.launch_plan(1, 8, 8, 4, 256, 1024, 31, SMS, capacity=capacity)
    assert plan.splits == 3 and 32 <= capacity[plan.splits - 1]
    ideal = da.launch_plan(1, 8, 8, 4, 256, 1024, 31, SMS)
    assert ideal.splits == 4


def test_launch_plan_refuses_more_than_64_query_heads_per_kv_head():
    with pytest.raises(ValueError, match="at most 64"):
        da.launch_plan(1, 1, 128, 1, 128, 64, 0, SMS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode-attention kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_slots,heads,kv,hd,softcap,window",
    [(4, 32, 8, 128, None, None), (1, 32, 8, 128, None, None), (4, 16, 8, 256, 50.0, 256),
     (16, 32, 8, 128, None, None)],
)
def test_kernel_matches_plain_version_on_card(cuda_device, n_slots, heads, kv, hd, softcap, window):
    """bf16 inputs; the plain version computes in fp32 from the same bf16
    values.  Tolerance atol 5e-3 + rtol 1e-2: bf16 output rounding (2^-8
    relative) plus fp32 sums in another order, as in chip_smoke.py."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n_roles, w0, ts, write_col = 3, 700, 50, 37
    rows = n_slots * n_roles

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)

    args = (randn(rows, heads, hd), randn(n_roles, w0, kv, hd), randn(n_roles, w0, kv, hd),
            randn(rows, ts, kv, hd), randn(rows, ts, kv, hd))
    starts = torch.tensor([0, 350, w0 - 1], dtype=torch.int32, device=cuda_device)
    qpos = (w0 - starts) + write_col
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    before = da.launches.count
    out = da.decode_attention(*args, starts, qpos, write_col, n_slots, n_roles, **kw)
    torch.cuda.synchronize()
    assert da.launches.count == before + 1
    ref = da.decode_attention_reference(*args, starts, qpos, write_col, n_slots, n_roles, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=5e-3, rtol=1e-2)


#: (P, R, H, KV, hd, W0, Ts, write_col, starts, softcap, window)
EDGE_CASES = {
    # Every role's trunk span empty: a row sees only its tail column 0.
    "empty trunk span, only tail column 0": (4, 3, 32, 8, 128, 256, 16, 0, [256, 256, 256],
                                             None, None),
    # One tail tile is the group's only work: all splits but one hold none.
    "every split but one empty": (1, 2, 32, 8, 128, 1024, 16, 0, [1024, 1024], None, None),
    # A tp rank's one query head over one kv head (gemma2-2b at tp=8 / 16).
    "tp rank, one head": (1, 8, 1, 1, 256, 128, 32, 31, [0, 5, 17, 64, 100, 127, 0, 3], 50.0,
                          None),
    # 16 slots x 4 query heads per kv head: 64 rows, a block's four row tiles.
    "64 rows per group": (16, 2, 32, 8, 128, 512, 40, 33, [0, 300], None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_kernel_edge_cases_on_card(cuda_device, name):
    """The cluster's edges: blocks with no keys, a group whose only keys are
    a tail column, one head a rank, a block's full 64 rows.  Tolerance as
    above."""
    n_slots, n_roles, heads, kv, hd, w0, ts, write_col, starts, softcap, window = EDGE_CASES[name]
    g = torch.Generator(device=cuda_device).manual_seed(1)
    rows = n_slots * n_roles

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)

    args = (randn(rows, heads, hd), randn(n_roles, w0, kv, hd), randn(n_roles, w0, kv, hd),
            randn(rows, ts, kv, hd), randn(rows, ts, kv, hd))
    sts = torch.tensor(starts, dtype=torch.int32, device=cuda_device)
    qpos = (w0 - sts) + write_col
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = da.launch_plan(n_slots, n_roles, heads, kv, hd, w0, write_col, sms)
    if name == "every split but one empty":
        assert plan.splits > 1
    out = da.decode_attention(*args, sts, qpos, write_col, n_slots, n_roles, **kw)
    torch.cuda.synchronize()
    ref = da.decode_attention_reference(*args, sts, qpos, write_col, n_slots, n_roles, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=5e-3, rtol=1e-2)
    if name.startswith("empty trunk") or name.startswith("every split"):
        # One valid key: the output is that key's value row, per query head.
        tail_v = args[4]
        expect = tail_v[:, 0].float().repeat_interleave(heads // kv, dim=1)
        torch.testing.assert_close(out.float(), expect, atol=5e-3, rtol=1e-2)
