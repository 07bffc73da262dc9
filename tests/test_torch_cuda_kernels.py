"""The hand-written CUDA kernels against their plain torch twins, on the
card. Skipped where there is no CUDA device; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports only the port). Integer
bit-equality throughout.
"""

import numpy as np
import pytest
import torch

from genome_downsampler_tpu_torch import _native
from genome_downsampler_tpu_torch.ops import ablate, blocked, sweep, variants
from genome_downsampler_tpu_torch.solvers.blocked_sweep import (
    BlockedWindowedMcpSolver,
    _cross_window_offsets,
    _selection_mask,
    pack_bits,
)
from genome_downsampler_tpu_torch.solvers.native_greedy import (
    NativeGreedyMcpSolver,
    native_greedy_select,
)
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform
from genome_downsampler_tpu_torch.testing import variant_cases
from genome_downsampler_tpu_torch.testing.ssp_cases import (
    BOUNDARY_CASES,
    boundary_case,
    ssp_network,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(geometry, seed=0):
    """(start, end, n, W, B, L, chunk) for a named geometry."""
    rng = np.random.default_rng(seed)
    if geometry == "small":
        b = rand_reads_uniform(rng, 800, 900, 48)
        return np.asarray(b.start, np.int64), np.asarray(b.end, np.int64), 900, 4, 64, 64, 64
    if geometry == "clumped":
        start = rng.integers(0, 40, 300)
        return start, start + rng.integers(5, 32, 300) - 1, 512, 4, 32, 32, 32
    if geometry == "config4":  # W, B, L of the config-4 solve, 300x deep
        n = 400_000
        start = rng.integers(0, n - 150, 800_000)
        return start, start + 149, n, 32, 128, 256, 128
    if geometry == "span384":  # the span-upgraded L with B = 128
        n = 60_000
        start = rng.integers(0, n - 400, 60_000)
        return start, start + rng.integers(30, 300, 60_000), n, 8, 128, 384, 128
    if geometry == "long768":  # L = 768 with B = 64: kernel C looks 12 groups back
        n = 4 * 16 * 64
        start = rng.integers(0, n - 768, 6000)
        return start, start + rng.integers(0, 767, 6000), n, 4, 64, 768, 64
    if geometry == "w1":  # one window: no earlier windows, xwin is zero
        start = rng.integers(0, 2000 - 100, 5000)
        return start, start + rng.integers(0, 99, 5000), 2000, 1, 128, 128, 128
    raise ValueError(geometry)


def _packed(geometry, dev, seed=0):
    start, end, n, W, B, L, chunk = _case(geometry, seed)
    packed, counts, win, n_pad, _ = _native.pack_blocked(
        start, end, n, W, B, L, cap_multiple=chunk
    )
    return (start, end, W, B, L, win, n_pad,
            torch.tensor(packed, device=dev), torch.tensor(counts, device=dev))


@pytest.mark.parametrize(
    "geometry,auto,grid_offset,seeded",
    [
        ("small", False, 0, False),
        ("small", True, 0, False),
        ("small", True, 2, True),
        ("small", False, 1, True),
        ("clumped", True, 0, False),
        ("config4", True, 94, False),
        ("config4", False, 95, True),
        ("span384", True, 55, False),
    ],
)
def test_sweep_kernel_matches_plain(cuda, geometry, auto, grid_offset, seeded):
    start, end, W, B, L, win, n_pad, p, c = _packed(geometry, cuda)
    m = 5
    target = None
    if not auto:
        target = torch.tensor(
            _native.capped_target(start, end, n_pad, m).reshape(W, win),
            device=cuda,
        )
    rng = np.random.default_rng(5)
    carries = [
        torch.tensor(rng.integers(0, 4, (W, L)).astype(np.int32) if seeded
                     else np.zeros((W, L), np.int32), device=cuda)
        for _ in range(3)
    ]
    kw = dict(grid_offset=grid_offset, avail0i=carries[2], auto_target=auto,
              max_coverage=m if auto else 0)
    n0 = blocked.blocked_sweep_pass.launches
    got = blocked.blocked_sweep_pass(p, c, target, carries[0], carries[1], W, B, L, **kw)
    torch.cuda.synchronize()
    assert blocked.blocked_sweep_pass.launches == n0 + 1
    ref = blocked.blocked_sweep_pass_plain(
        p, c, target, carries[0], carries[1], W, B, L, **kw
    )
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _kernel_b_case(L, B, seed):
    """Packed codes of W=4 windows of 4 blocks: about 2 reads starting per
    position with spans 1..L-1, and 300 more starting at one position of
    window 1 (more than 255: int16 headroom). At L >= 512 a block of B > 64
    positions is more than one chunk of the kernel."""
    rng = np.random.default_rng(seed)
    W, n = 4, 4 * 4 * B
    start = rng.integers(0, n - L, 2 * n)
    end = start + rng.integers(0, L - 1, 2 * n)
    hot = np.full(300, 4 * B + B // 2 + 1)
    start = np.concatenate([start, hot])
    end = np.concatenate([end, hot + rng.integers(0, min(L - 1, n - hot[0]), 300)])
    packed, counts, win, n_pad, _ = _native.pack_blocked(
        start, end, n, W, B, L, cap_multiple=64
    )
    return start, end, W, win, n_pad, packed, counts


@pytest.mark.parametrize("auto,grid_offset,seeded", [(True, 1, True), (False, 0, False),
                                                     (False, 2, True)])
@pytest.mark.parametrize("B", [64, 128, 256])
@pytest.mark.parametrize("L", [64, 256, 384, 768])
def test_sweep_kernel_b_geometries_match_plain(cuda, L, B, auto, grid_offset, seeded):
    start, end, W, win, n_pad, packed, counts = _kernel_b_case(L, B, L + B)
    assert np.bincount(start).max() > 255
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    m = 9
    target = None if auto else torch.tensor(
        _native.capped_target(start, end, n_pad, m).reshape(W, win), device=cuda)
    rng = np.random.default_rng(B)
    carries = [
        torch.tensor(rng.integers(0, 4, (W, L)).astype(np.int32) if seeded
                     else np.zeros((W, L), np.int32), device=cuda)
        for _ in range(3)
    ]
    kw = dict(grid_offset=grid_offset, avail0i=carries[2], auto_target=auto,
              max_coverage=m if auto else 0)
    got = blocked.blocked_sweep_pass(p, c, target, carries[0], carries[1], W, B, L, **kw)
    torch.cuda.synchronize()
    ref = blocked.blocked_sweep_pass_plain(p, c, target, carries[0], carries[1], W, B, L,
                                           **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert ref[0].any()


@pytest.mark.parametrize("hot,spread", [(40_000, 0), (0, 70_000)])
def test_sweep_kernel_b_takes_groups_beyond_32768_codes(cuda, hot, spread):
    """One group of more than 32,768 codes: 40,000 reads starting at one
    position (beyond int16, within the kernel's uint16 counts), or 70,000
    spread over one block (cap above 65,535: the wrapper counts starts per
    position and launches)."""
    rng = np.random.default_rng(hot + spread)
    W, B, L, n = 2, 64, 64, 256
    start = rng.integers(0, n - L, 2 * n)
    start = np.concatenate([start, np.full(hot, B + 6), 2 * B + np.arange(spread) % B])
    end = start + rng.integers(0, L - 1, start.shape[0])
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, W, B, L,
                                                         cap_multiple=64)
    assert counts.max() > 32768 and np.bincount(start).max() <= 65535
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    m = 30
    for auto in (True, False):
        target = None if auto else torch.tensor(
            _native.capped_target(start, end, n_pad, m).reshape(W, win), device=cuda)
        z = torch.zeros((W, L), dtype=torch.int32, device=cuda)
        kw = dict(avail0i=z, auto_target=auto, max_coverage=m if auto else 0)
        got = blocked.blocked_sweep_pass(p, c, target, z, z, W, B, L, **kw)
        torch.cuda.synchronize()
        ref = blocked.blocked_sweep_pass_plain(p, c, target, z, z, W, B, L, **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


@pytest.mark.parametrize("hot", [70_000, 100_000])
def test_sweep_kernel_b_takes_more_than_65535_starts_at_one_position(cuda, hot):
    """More reads of a window start at one position than uint16 counts: the
    wrapper counts them and launches the wide path (int32 counts)."""
    rng = np.random.default_rng(hot)
    W, B, L, n = 2, 64, 64, 256
    start = rng.integers(0, n - L, 2 * n)
    end = np.concatenate([start + rng.integers(0, L - 1, start.shape[0]),
                          np.full(hot, B + 35)])
    start = np.concatenate([start, np.full(hot, B + 5)])
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, W, B, L,
                                                         cap_multiple=64)
    assert np.bincount(start).max() > 65535
    assert blocked._max_starts(torch.tensor(packed), B, L) > 65535
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    m = 80_000
    for auto, seeded in ((True, False), (False, True)):
        target = None if auto else torch.tensor(
            _native.capped_target(start, end, n_pad, m).reshape(W, win), device=cuda)
        g = np.random.default_rng(1)
        carries = [torch.tensor(g.integers(0, 4, (W, L)).astype(np.int32) if seeded
                                else np.zeros((W, L), np.int32), device=cuda)
                   for _ in range(3)]
        kw = dict(avail0i=carries[2], auto_target=auto, max_coverage=m if auto else 0)
        n0 = (blocked.blocked_sweep_pass.launches, blocked.blocked_sweep_wide.launches)
        got = blocked.blocked_sweep_pass(p, c, target, carries[0], carries[1], W, B, L, **kw)
        torch.cuda.synchronize()
        assert (blocked.blocked_sweep_pass.launches,
                blocked.blocked_sweep_wide.launches) == (n0[0], n0[1] + 1)
        ref = blocked.blocked_sweep_pass_plain(p, c, target, carries[0], carries[1], W, B,
                                               L, **kw)
        for g_, r in zip(got, ref):
            assert torch.equal(g_, r)
        assert int(ref[0].max()) > 65535


def _long_case(L, seed, B=128, W=4):
    """W windows of max(4 B, L) positions (a window at least L long), about
    2 reads starting per position with spans 1..L-1."""
    rng = np.random.default_rng(seed)
    win = max(4 * B, -(-L // B) * B)
    n = W * win
    start = rng.integers(0, n - L, 2 * n)
    end = start + rng.integers(0, L - 1, 2 * n)
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, W, B, L,
                                                         cap_multiple=64)
    return start, end, W, B, win, n_pad, packed, counts


@pytest.mark.parametrize("auto,grid_offset,seeded", [(True, 0, False), (False, 1, True),
                                                     (True, 2, True)])
@pytest.mark.parametrize("L", [896, 1024, 1280, 2048, 4096])
def test_sweep_kernel_b_long_spans_match_plain(cuda, L, auto, grid_offset, seeded):
    """L above the register path's 768 (1,280: neither a power of two nor
    a register-path span): the wide path, per-end counts in shared
    memory."""
    start, end, W, B, win, n_pad, packed, counts = _long_case(L, L)
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    m = 9
    target = None if auto else torch.tensor(
        _native.capped_target(start, end, n_pad, m).reshape(W, win), device=cuda)
    rng = np.random.default_rng(L + grid_offset)
    carries = [torch.tensor(rng.integers(0, 4, (W, L)).astype(np.int32) if seeded
                            else np.zeros((W, L), np.int32), device=cuda)
               for _ in range(3)]
    kw = dict(grid_offset=grid_offset, avail0i=carries[2], auto_target=auto,
              max_coverage=m if auto else 0)
    got = blocked.blocked_sweep_pass(p, c, target, carries[0], carries[1], W, B, L, **kw)
    torch.cuda.synchronize()
    ref = blocked.blocked_sweep_pass_plain(p, c, target, carries[0], carries[1], W, B, L,
                                           **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert ref[0].any()


@pytest.mark.parametrize("L", [896, 1024, 1280, 2048, 4096])
def test_select_kernel_long_spans_match_plain_and_argsort(cuda, L):
    """Kernel C's run-time-L instantiation (L above 768)."""
    start, end, W, B, win, n_pad, packed, counts = _long_case(L, L + 1)
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    sel, _ = blocked.blocked_windowed_sweep(p, c, None, W, B, L, auto_target=True,
                                            max_coverage=9)
    xwin = torch.tensor(_cross_window_offsets(start, end, win, W, B, L), device=cuda)
    assert xwin.any()
    got = blocked.blocked_selection_pass(p, c, sel, xwin, W, B, L)
    torch.cuda.synchronize()
    assert torch.equal(got, blocked.blocked_selection_pass_plain(p, c, sel, xwin, W, B, L))
    bits, n_sel = _selection_mask(p, sel, W, B, L, win)
    assert torch.equal(pack_bits(got), bits) and int(got.sum()) == n_sel > 0


@pytest.mark.parametrize("auto,grid_offset,seeded", [(True, 0, False), (False, 1, True)])
@pytest.mark.parametrize("L", [1280, 4096])
def test_sweep_kernel_b_wide_path_amplicon_stacks_match_plain(cuda, L, auto, grid_offset,
                                                               seeded):
    """Amplicon stacks: about 300 reads starting at each of a few positions
    (one of them where a block ends), spans spread up to L - 1, over a thin
    uniform background; the wide path launched, bit-equal to the twin."""
    rng = np.random.default_rng(L + 7)
    W, B = 4, 128
    win = max(4 * B, -(-L // B) * B)
    n = W * win
    start = rng.integers(0, n - L, n // 4)
    end = start + rng.integers(0, L - 1, n // 4)
    for s0 in (5, B - 1, win + 3 * B // 2, 2 * win + 17):
        start = np.concatenate([start, np.full(300, s0)])
        end = np.concatenate([end, s0 + rng.integers(L // 2, L - 1, 300)])
    end = np.minimum(end, n - 1)
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, W, B, L,
                                                         cap_multiple=64)
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    m = 120
    target = None if auto else torch.tensor(
        _native.capped_target(start, end, n_pad, m).reshape(W, win), device=cuda)
    g = np.random.default_rng(L)
    carries = [torch.tensor(g.integers(0, 4, (W, L)).astype(np.int32) if seeded
                            else np.zeros((W, L), np.int32), device=cuda)
               for _ in range(3)]
    kw = dict(grid_offset=grid_offset, avail0i=carries[2], auto_target=auto,
              max_coverage=m if auto else 0)
    n0 = blocked.blocked_sweep_wide.launches
    got = blocked.blocked_sweep_pass(p, c, target, carries[0], carries[1], W, B, L, **kw)
    torch.cuda.synchronize()
    assert blocked.blocked_sweep_wide.launches == n0 + 1
    ref = blocked.blocked_sweep_pass_plain(p, c, target, carries[0], carries[1], W, B, L,
                                           **kw)
    for g_, r in zip(got, ref):
        assert torch.equal(g_, r)
    assert ref[0].any()


@pytest.mark.parametrize("L,B", [(64, 64), (256, 128), (768, 256)])
def test_sweep_kernel_b_wide_path_matches_register_path(cuda, L, B):
    """Called directly where the register path also runs: both bit-equal to
    each other and to the twin, from seeded carries at grid offset 1."""
    start, end, W, win, n_pad, packed, counts = _kernel_b_case(L, B, L + B + 1)
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    rng = np.random.default_rng(B)
    carries = [torch.tensor(rng.integers(0, 4, (W, L)).astype(np.int32), device=cuda)
               for _ in range(3)]
    kw = dict(grid_offset=1, avail0i=carries[2], auto_target=True, max_coverage=9)
    got = blocked.blocked_sweep_wide(p, c, None, carries[0], carries[1], W, B, L, **kw)
    reg = blocked.blocked_sweep_pass(p, c, None, carries[0], carries[1], W, B, L, **kw)
    torch.cuda.synchronize()
    ref = blocked.blocked_sweep_pass_plain(p, c, None, carries[0], carries[1], W, B, L, **kw)
    for g, r, x in zip(got, reg, ref):
        assert torch.equal(g, x) and torch.equal(r, x)


@pytest.mark.parametrize("L", [1280, 3072])
def test_wide_path_and_select_kernel_at_block_256_match_plain(cuda, L):
    """B = 256 (midnight-30kb's block) at a run-time L: the wide path from
    seeded carries at grid offset 1 and kernel C on the windowed sweep's
    selection, each bit-equal to its twin."""
    start, end, W, B, win, n_pad, packed, counts = _long_case(L, L + 3, B=256)
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    rng = np.random.default_rng(L)
    carries = [torch.tensor(rng.integers(0, 4, (W, L)).astype(np.int32), device=cuda)
               for _ in range(3)]
    kw = dict(grid_offset=1, avail0i=carries[2], auto_target=True, max_coverage=9)
    got = blocked.blocked_sweep_pass(p, c, None, carries[0], carries[1], W, B, L, **kw)
    torch.cuda.synchronize()
    ref = blocked.blocked_sweep_pass_plain(p, c, None, carries[0], carries[1], W, B, L, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    sel, _ = blocked.blocked_windowed_sweep(p, c, None, W, B, L, auto_target=True,
                                            max_coverage=9)
    xwin = torch.tensor(_cross_window_offsets(start, end, win, W, B, L), device=cuda)
    got = blocked.blocked_selection_pass(p, c, sel, xwin, W, B, L)
    torch.cuda.synchronize()
    assert torch.equal(got, blocked.blocked_selection_pass_plain(p, c, sel, xwin, W, B, L))
    assert int(got.sum()) > 0


def _deep_amplicons(seed):
    """artic-deep-30kb's layout on 2,000 bases: 5 amplicons of 400 bases
    at a stride of 300, 70,000 pairs each (more than 65,535 first mates
    start at each primer), 100-150 bases; packed at its W, B, L."""
    from genome_downsampler_tpu_torch.testing import long_reads

    b = long_reads.amplicon_pairs(np.random.default_rng(seed), 2_000, 5, 30, 300, 400,
                                  350_000, 100, 150)
    start, end = np.asarray(b.start, np.int64), np.asarray(b.end, np.int64)
    W, B, L = 4, 256, 256
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, 2_000, W, B, L,
                                                         cap_multiple=256)
    return b, start, end, W, B, L, win, n_pad, packed, counts


@pytest.mark.parametrize("auto,grid_offset,seeded", [(True, 0, False), (False, 1, True)])
def test_sweep_kernel_b_deep_amplicon_stacks_match_plain(cuda, auto, grid_offset, seeded):
    """Stacks of 70,000 reads with 51 spans at each primer and of about
    1,400 with one span where the second mates start: the wrapper sends
    them to the wide path, whose stack fold (up to 16 neighbouring codes a
    lane, one add a run) is bit-equal to the twin; kernel C too."""
    _, start, end, W, B, L, win, n_pad, packed, counts = _deep_amplicons(5)
    assert np.bincount(start).max() > 65535
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    m = 1000
    target = None if auto else torch.tensor(
        _native.capped_target(start, end, n_pad, m).reshape(W, win), device=cuda)
    g = np.random.default_rng(grid_offset)
    carries = [torch.tensor(g.integers(0, 4, (W, L)).astype(np.int32) if seeded
                            else np.zeros((W, L), np.int32), device=cuda)
               for _ in range(3)]
    kw = dict(grid_offset=grid_offset, avail0i=carries[2], auto_target=auto,
              max_coverage=m if auto else 0)
    n0 = (blocked.blocked_sweep_pass.launches, blocked.blocked_sweep_wide.launches)
    got = blocked.blocked_sweep_pass(p, c, target, carries[0], carries[1], W, B, L, **kw)
    torch.cuda.synchronize()
    assert (blocked.blocked_sweep_pass.launches,
            blocked.blocked_sweep_wide.launches) == (n0[0], n0[1] + 1)
    ref = blocked.blocked_sweep_pass_plain(p, c, target, carries[0], carries[1], W, B, L,
                                           **kw)
    for g_, r in zip(got, ref):
        assert torch.equal(g_, r)
    assert ref[0].any()
    if auto:
        sel, _ = blocked.blocked_windowed_sweep(p, c, None, W, B, L, auto_target=True,
                                                max_coverage=m)
        xwin = torch.tensor(_cross_window_offsets(start, end, win, W, B, L), device=cuda)
        got = blocked.blocked_selection_pass(p, c, sel, xwin, W, B, L)
        torch.cuda.synchronize()
        assert torch.equal(got, blocked.blocked_selection_pass_plain(p, c, sel, xwin, W, B,
                                                                     L))


def test_blocked_solver_cuda_deep_amplicons_match_host_greedy(cuda):
    """mcp-cuda-blocked on the deep amplicon pairs: the read set of
    mcp-cpu, every pass on the wide path."""
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    batch = _deep_amplicons(6)[0]
    reg = default_registry()
    n0 = (blocked.blocked_sweep_pass.launches, blocked.blocked_sweep_wide.launches)
    sel = reg.get("mcp-cuda-blocked").solve(1000, batch)
    assert blocked.blocked_sweep_pass.launches == n0[0]
    assert blocked.blocked_sweep_wide.launches > n0[1]
    np.testing.assert_array_equal(sel, reg.get("mcp-cpu").solve(1000, batch))


@pytest.mark.parametrize("span", [1000, 4094])
def test_blocked_solver_cuda_long_reads_match_host_greedy(cuda, span):
    """mcp-cuda-blocked on reads of up to 1,000 (L = 1,024) and 4,094 bases
    (L = 4,096): the read set of mcp-cpu."""
    from genome_downsampler_tpu_torch.core.readbatch import ReadBatch
    from genome_downsampler_tpu_torch.solvers.registry import default_registry

    rng = np.random.default_rng(span)
    n, r = 300_000, 60_000
    start = rng.integers(0, n - span, r)
    end = start + rng.integers(0, span, r)
    batch = ReadBatch(bam_id=np.arange(r), start=start, end=end,
                      quality=np.full(r, 50, np.int64), seq_length=end - start + 1,
                      is_first=np.tile([True, False], r // 2), ref_genome_length=n)
    reg = default_registry()
    solver = reg.get("mcp-cuda-blocked")
    for m in (5, 30):
        sel = solver.solve(m, batch)
        np.testing.assert_array_equal(sel, reg.get("mcp-cpu").solve(m, batch))
        assert solver.inner.last_stats["max_span"] == -(-(span + 2) // 128) * 128


def _ssp_inputs(seed):
    """The SSP network of seeded reads: seeds 0-5 are the inputs of the JAX
    suite's random LP cases (N = 600), 6 and 7 cuts of config-1 at its depth
    to 1,500 and 10,000 bases (on 132 SMs: 6 CTAs of 251 nodes and 40 CTAs
    of 251, so the carries between CTAs are held to the twin)."""
    rng = np.random.default_rng(seed)
    if seed < 6:
        r = int(rng.integers(8, 300))
        start = rng.integers(0, 600, r)
        end = np.minimum(start + rng.integers(1, 150, r), 599)
        cost, n, m = rng.integers(1, 60, r), 600, int(rng.integers(1, 9))
    else:
        pairs, n = (1254, 1500) if seed == 6 else (8360, 10_000)
        b = rand_reads_uniform(np.random.default_rng(12345), pairs, n, 150)
        start, end = np.asarray(b.start, np.int64), np.asarray(b.end, np.int64)
        q = np.asarray(b.quality, np.int64)
        cost, m = q.max() - q + 1, 100
    return ssp_network(start, end, cost, n, m)


def _ssp_equal(cuda, arrays, phase_cap):
    from genome_downsampler_tpu_torch.ops import ssp

    n0 = ssp.ssp_solve.launches
    got = ssp.ssp_solve(*(a.to(cuda) for a in arrays), phase_cap)
    torch.cuda.synchronize()
    assert ssp.ssp_solve.launches == n0 + 1
    ref = ssp.ssp_solve_plain(*arrays, phase_cap)
    assert torch.equal(got[0].cpu(), ref[0]) and got[1:] == ref[1:]
    return got


@pytest.mark.parametrize("seed", range(8))
def test_ssp_kernel_matches_plain(cuda, seed):
    from genome_downsampler_tpu_torch.ops import ssp

    arrays, supply0 = _ssp_inputs(seed)
    _, supply, status, phases, rounds = _ssp_equal(cuda, arrays, supply0 + 16)
    assert (supply, status) == (0, ssp.OK) and rounds >= phases >= 1
    # cut short: the same status, DEGENERATE with supply left, from both
    if supply0 > 1:
        assert _ssp_equal(cuda, arrays, 1)[2] == ssp.DEGENERATE


@pytest.mark.parametrize("name", BOUNDARY_CASES)
def test_ssp_kernel_cta_boundaries_match_plain(cuda, name):
    from genome_downsampler_tpu_torch.ops import ssp

    arrays, supply0 = ssp_network(*boundary_case(name))
    n = arrays[7].shape[0] - 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    G, C = ssp.grid_shape(n, sms)
    assert G > 1 and (name != "ragged chunks" or (n + 1) % C != 0)
    if name == "stacked amplicons":
        _, range_f, _, _, _, _ = ssp.bucket_ranges(arrays[0], arrays[1], n, G, C)
        per_cta = (range_f[1:] - range_f[:-1]).tolist()
        assert max(per_cta) > sum(per_cta) // 2
    _, supply, status, phases, rounds = _ssp_equal(cuda, arrays, supply0 + 16)
    assert (supply, status) == (0, ssp.OK) and rounds >= phases >= 1
    assert _ssp_equal(cuda, arrays, 1)[2] == ssp.DEGENERATE


def test_ssp_kernel_raises_where_its_ctas_cannot_be_resident(cuda):
    """5,000 CTAs of 256 threads exceed what 132 SMs hold at once: the
    C entry refuses the cooperative launch and the check raises."""
    from genome_downsampler_tpu_torch.ops import build, ssp

    arrays, supply0 = _ssp_inputs(7)
    a = [x.to(cuda) for x in arrays]
    n, B, G = a[7].shape[0] - 1, a[0].shape[0], 5_000
    C = -(-(n + 1) // G)
    order_f, range_f, _, order_b, range_b, _ = ssp.bucket_ranges(a[0], a[1], n, G, C)
    flow = torch.empty(B, dtype=torch.int32, device=cuda)
    scalars = torch.empty(4, dtype=torch.int32, device=cuda)
    ws = torch.empty(ssp._ws_words(n, B, G), dtype=torch.int32, device=cuda)
    lib = build.load_kernels()
    rc = lib.gd_ssp_solve(*(x.data_ptr() for x in a), order_f.data_ptr(), range_f.data_ptr(),
                          order_b.data_ptr(), range_b.data_ptr(), flow.data_ptr(),
                          scalars.data_ptr(), ws.data_ptr(), n, B, a[4].shape[0], G, B, B,
                          supply0 + 16, torch.cuda.current_stream(cuda).cuda_stream)
    with pytest.raises(RuntimeError, match="gd_ssp_solve"):
        build.check("gd_ssp_solve", rc)


def test_ssp_kernel_reports_an_infeasible_network(cuda):
    """One unit at node 0 and its demand at node 10, one bucket arc 5 -> 6:
    no residual path from 0 reaches 10."""
    from genome_downsampler_tpu_torch.ops import ssp

    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    excess = torch.zeros(11, dtype=torch.int32)
    excess[0], excess[10] = 1, -1
    arrays = [i32(5), i32(6), i32(0), i32(1), i32(1), i32(0), i32(0), excess]
    assert _ssp_equal(cuda, arrays, 17)[2] == ssp.INFEASIBLE


def test_qmcp_cuda_matches_qmcp_cpu_in_cost(cuda):
    from genome_downsampler_tpu_torch.solvers.registry import default_registry
    from genome_downsampler_tpu_torch.testing.fixtures import small_example_batch

    reg = default_registry()
    for batch, m in ((rand_reads_uniform(np.random.default_rng(12345), 2508, 3000, 150), 100),
                     (small_example_batch(), 4)):
        q = np.asarray(batch.quality, np.int64)
        cost = q.max() - q + 1
        solver = reg.get("qmcp-cuda")
        sel = solver.solve(m, batch)
        host = reg.get("qmcp-cpu").solve(m, batch)
        assert cost[sel].sum() == cost[host].sum()
        st = solver.inner.last_stats
        assert st["engine"] == "device"
        n = batch.ref_genome_length
        cov_in = np.zeros(n + 1, np.int64)
        np.add.at(cov_in, batch.start, 1)
        np.add.at(cov_in, batch.end + 1, -1)
        cov = np.zeros(n + 1, np.int64)
        np.add.at(cov, batch.start[sel], 1)
        np.add.at(cov, batch.end[sel] + 1, -1)
        assert np.all(np.cumsum(cov) >= np.minimum(np.cumsum(cov_in), m))


@pytest.mark.parametrize("geometry", ["small", "clumped", "config4", "span384"])
def test_windowed_sweep_cuda_matches_host_greedy(cuda, geometry):
    start, end, W, B, L, win, n_pad, p, c = _packed(geometry, cuda)
    m = 7
    sel, rounds = blocked.blocked_windowed_sweep(
        p, c, None, W, B, L, auto_target=True, max_coverage=m
    )
    host = native_greedy_select(start, end, n_pad, m)
    np.testing.assert_array_equal(
        sel.cpu().numpy(), np.bincount(end[host], minlength=n_pad)
    )
    if geometry in ("small", "clumped"):  # the CPU twin is slow at scale
        sel_cpu, rounds_cpu = blocked.blocked_windowed_sweep(
            p.cpu(), c.cpu(), None, W, B, L, auto_target=True, max_coverage=m
        )
        assert torch.equal(sel.cpu(), sel_cpu) and rounds == rounds_cpu


@pytest.mark.parametrize("geometry,m", [("small", 6), ("clumped", 3), ("config4", 50),
                                        ("long768", 9), ("w1", 12)])
def test_select_kernel_matches_plain_and_argsort(cuda, geometry, m):
    start, end, W, B, L, win, n_pad, p, c = _packed(geometry, cuda)
    sel, _ = blocked.blocked_windowed_sweep(
        p, c, None, W, B, L, auto_target=True, max_coverage=m
    )
    xwin = torch.tensor(_cross_window_offsets(start, end, win, W, B, L), device=cuda)
    if geometry in ("small", "long768"):
        assert xwin.any()  # reads of earlier windows end in these windows
    n0 = blocked.blocked_selection_pass.launches
    got = blocked.blocked_selection_pass(p, c, sel, xwin, W, B, L)
    torch.cuda.synchronize()
    assert blocked.blocked_selection_pass.launches == n0 + 1
    assert torch.equal(got, blocked.blocked_selection_pass_plain(p, c, sel, xwin, W, B, L))
    bits, n_sel = _selection_mask(p, sel, W, B, L, win)
    assert torch.equal(pack_bits(got), bits) and int(got.sum()) == n_sel


@pytest.mark.parametrize("hot,spread", [(40_000, 0), (0, 70_000)])
def test_select_kernel_takes_groups_of_40000_and_70000_codes(cuda, hot, spread):
    """One group of 40,000 codes (reads starting at one position) or 70,000
    (spread over one block): the CTA's four warps split the walk. One
    window, so the twin's (cap, cap) comparison fits the card."""
    rng = np.random.default_rng(hot + spread + 1)
    W, B, L, n = 1, 64, 64, 256
    start = rng.integers(0, n - L, 2 * n)
    start = np.concatenate([start, np.full(hot, B + 6), 2 * B + np.arange(spread) % B])
    end = start + rng.integers(0, L - 1, start.shape[0])
    packed, counts, win, _, _ = _native.pack_blocked(start, end, n, W, B, L,
                                                     cap_multiple=64)
    assert counts.max() > 32768
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    sel, _ = blocked.blocked_windowed_sweep(p, c, None, W, B, L, auto_target=True,
                                            max_coverage=30)
    xwin = torch.zeros((W, B + L), dtype=torch.int32, device=cuda)
    got = blocked.blocked_selection_pass(p, c, sel, xwin, W, B, L)
    torch.cuda.synchronize()
    assert torch.equal(got, blocked.blocked_selection_pass_plain(p, c, sel, xwin, W, B, L))
    bits, n_sel = _selection_mask(p, sel, W, B, L, win)
    assert torch.equal(pack_bits(got), bits) and int(got.sum()) == n_sel > 0


@pytest.mark.parametrize("L", [48, 4128])
def test_select_kernel_rejects_unsupported_span(cuda, L):
    """Not a multiple of 32, or above 4096: kernels B and C refuse, naming
    the bound."""
    p = torch.full((1, 1, 64), -1, dtype=torch.int32, device=cuda)
    c = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    sel = torch.zeros(64, dtype=torch.int32, device=cuda)
    xwin = torch.zeros((1, 64 + L), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="max_span up to 4096"):
        blocked.blocked_selection_pass(p, c, sel, xwin, 1, 64, L)
    z = torch.zeros((1, L), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="max_span up to 4096"):
        blocked.blocked_sweep_pass(p, c, None, z, z, 1, 64, L, avail0i=z,
                                   auto_target=True, max_coverage=3)


def test_solver_cuda_matches_cpu_and_host_greedy(cuda):
    rng = np.random.default_rng(9)
    batch = rand_reads_uniform(rng, 20_000, 300_000, 150)
    for m in (5, 40):
        gpu = BlockedWindowedMcpSolver("cuda")
        sel = gpu.solve(m, batch)
        np.testing.assert_array_equal(sel, BlockedWindowedMcpSolver("cpu").solve(m, batch))
        np.testing.assert_array_equal(sel, NativeGreedyMcpSolver().solve(m, batch))
        assert gpu.last_stats["rounds"] >= 1


def _dense_case(S, n, L, m, seed):
    """Arrival rows [S, n, L] and capped targets [S, n] of S seeded samples."""
    rows, targets = [], []
    for s in range(S):
        rng = np.random.default_rng(seed + s)
        b = rand_reads_uniform(rng, n // 2, n, min(L - 4, n // 4))
        start, end = np.asarray(b.start), np.asarray(b.end)
        r = np.zeros((n, L), np.int32)
        np.add.at(r, (start, end - start), 1)
        rows.append(r)
        targets.append(_native.capped_target(start, end, n, m))
    return np.stack(rows), np.stack(targets)


@pytest.mark.parametrize(
    "S,n,L,seeded,takes",
    [
        (1, 4096, 64, False, False),
        (1, 4096, 64, True, True),
        (4, 4096, 64, True, False),
        (4, 4096, 64, False, True),
        (3, 1000, 32, True, False),
        (3, 1000, 32, False, True),
        (2, 700, 768, True, True),
        (2, 700, 768, False, False),
        (2, 2000, 256, True, False),
        # n below one chunk of positions (64 at L=256, 512 at L=32), and n
        # not a multiple of it
        (1, 63, 256, True, False),
        (1, 100, 32, False, True),
        (2, 65, 256, False, True),
        # more rows than SMs
        (140, 300, 64, True, False),
    ],
)
def test_dense_sweep_kernel_matches_plain(cuda, S, n, L, seeded, takes):
    rows, target = _dense_case(S, n, L, 6, seed=S * 100 + L)
    rng = np.random.default_rng(5)
    carries = [
        torch.tensor(rng.integers(0, 4, (S, L)).astype(np.int32) if seeded
                     else np.zeros((S, L), np.int32), device=cuda)
        for _ in range(2)
    ]
    args = (torch.tensor(rows, device=cuda), torch.tensor(target, device=cuda),
            *carries, L)
    n0 = sweep.dense_sweep_counts.launches
    got = sweep.dense_sweep_counts(*args, takes=takes)
    torch.cuda.synchronize()
    assert sweep.dense_sweep_counts.launches == n0 + 1
    ref = sweep.dense_sweep_counts_plain(*args, takes=takes)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("takes", [False, True])
def test_dense_sweep_kernel_takes_no_positions(cuda, takes):
    rng = np.random.default_rng(1)
    a0, s0 = (torch.tensor(rng.integers(0, 4, (2, 64)).astype(np.int32), device=cuda)
              for _ in range(2))
    rows = torch.zeros((2, 0, 64), dtype=torch.int32, device=cuda)
    t = torch.zeros((2, 0), dtype=torch.int32, device=cuda)
    got = sweep.dense_sweep_counts(rows, t, a0, s0, 64, takes=takes)
    torch.cuda.synchronize()
    ref = sweep.dense_sweep_counts_plain(rows, t, a0, s0, 64, takes=takes)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert torch.equal(got[1], a0) and torch.equal(got[2], s0)


@pytest.mark.parametrize("takes", [False, True])
def test_dense_sweep_kernel_counts_100000_starts_at_one_position(cuda, takes):
    """100,000 reads of one span start at one position: the arrival count,
    its suffix sums, the take and the emitted count exceed 16 bits."""
    rng = np.random.default_rng(4)
    n, L, m = 2000, 256, 80_000
    start = rng.integers(0, n - L, 4000)
    end = np.concatenate([start + rng.integers(0, L - 1, 4000), np.full(100_000, 899)])
    start = np.concatenate([start, np.full(100_000, 700)])
    rows = np.zeros((1, n, L), np.int32)
    np.add.at(rows[0], (start, end - start), 1)
    target = _native.capped_target(start, end, n, m)[None]
    z = torch.zeros((1, L), dtype=torch.int32, device=cuda)
    args = (torch.tensor(rows, device=cuda), torch.tensor(target, device=cuda), z, z, L)
    got = sweep.dense_sweep_counts(*args, takes=takes)
    torch.cuda.synchronize()
    ref = sweep.dense_sweep_counts_plain(*args, takes=takes)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int(ref[0].max()) > 65535


def test_dense_sweep_kernel_rejects_unsupported_span(cuda):
    z = torch.zeros((1, 48), dtype=torch.int32, device=cuda)
    rows = torch.zeros((1, 10, 48), dtype=torch.int32, device=cuda)
    t = torch.zeros((1, 10), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="max_span"):
        sweep.dense_sweep_counts(rows, t, z, z, 48)


def test_dense_solvers_cuda_match_host_greedy(cuda):
    from genome_downsampler_tpu_torch.parallel.windows import WindowedMcpSolver
    from genome_downsampler_tpu_torch.solvers.batched import solve_batch
    from genome_downsampler_tpu_torch.solvers.device_sweep import (
        McpDeviceSweepSolver,
        QmcpDeviceSweepSolver,
    )

    batches = [rand_reads_uniform(np.random.default_rng(s), 5000, 30_000, 150)
               for s in range(3)]
    host = NativeGreedyMcpSolver()
    m = 20
    n0 = sweep.dense_sweep_counts.launches
    gpu = McpDeviceSweepSolver("cuda")
    for b in batches:
        np.testing.assert_array_equal(gpu.solve(m, b), host.solve(m, b))
        assert gpu.last_stats["engine"] == "dense"
    win = WindowedMcpSolver("cuda", n_windows=8)
    np.testing.assert_array_equal(win.solve(m, batches[0]), host.solve(m, batches[0]))
    assert 1 <= win.last_stats["rounds"] <= 8
    for b, sel in zip(batches, solve_batch(batches, m, "cuda")):
        np.testing.assert_array_equal(sel, host.solve(m, b))
    q = QmcpDeviceSweepSolver("cuda").solve(m, batches[1])
    assert len(q) == len(host.solve(m, batches[1]))
    assert sweep.dense_sweep_counts.launches > n0


@pytest.mark.parametrize("L", [32, 64, 128, 256])
@pytest.mark.parametrize("edge", ["1", "P-1", "P", "P+1", "2P+1", "ragged", "deep stack"])
def test_sweep_variants_match_plain_and_kernel_a(cuda, L, edge):
    # rows at the edges of the kernels' chunks (and of variant B's groups of
    # L / 32 positions), the rows the CPU tests hold the twins to the JAX
    # package's Pallas variants on; the deep stack is 3,000 reads starting
    # at one position, M = 1000
    lengths = variant_cases.edge_lengths(L)
    if edge == "deep stack":
        n, m, stack = lengths["ragged"] + L, 1000, 3000
    else:
        n, m, stack = lengths[edge], L // 4, 0
    rows, target = variant_cases.variant_case(n, L, m, seed=L + n, stack=stack)
    r = torch.tensor(rows, device=cuda)
    t = torch.tensor(target, device=cuda)
    z = torch.zeros((1, L), dtype=torch.int32, device=cuda)
    ref = sweep.dense_sweep_counts(r[None], t[None], z, z, L)[0][0]
    rot = variants.rotate_rows(r)
    n0 = (variants.sweep_variant_c.launches, variants.sweep_variant_b.launches)
    got_c = variants.sweep_variant_c(r, t, L)
    got_b = variants.sweep_variant_b(rot, t, L)
    torch.cuda.synchronize()
    assert (variants.sweep_variant_c.launches, variants.sweep_variant_b.launches) == (
        n0[0] + 1, n0[1] + 1)
    assert torch.equal(got_c, ref) and torch.equal(got_b, ref)
    assert torch.equal(got_c, variants.sweep_variant_c_plain(r, t, L))
    assert torch.equal(got_b, variants.sweep_variant_b_plain(rot, t, L))
    if n > 1:
        assert ref.any()


@pytest.mark.parametrize("L", [32, 256])
def test_sweep_variants_empty_row_launches_nothing(cuda, L):
    r = torch.zeros((0, L), dtype=torch.int32, device=cuda)
    t = torch.zeros(0, dtype=torch.int32, device=cuda)
    n0 = (variants.sweep_variant_c.launches, variants.sweep_variant_b.launches)
    for fn in (variants.sweep_variant_c, variants.sweep_variant_b):
        out = fn(r, t, L)
        assert out.shape == (0,) and out.device.type == "cuda"
    assert (variants.sweep_variant_c.launches, variants.sweep_variant_b.launches) == n0


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("L", [32, 64, 128, 256])
def test_sweep_variants_geometry_and_no_spill(cuda, L, ring):
    info = variants.kernel_info(L, ring)
    assert info["chunk_positions"] == variants.chunk_positions(L)
    assert info["shared_bytes"] == variants.shared_bytes(L)
    assert info["local_bytes"] == 0 and 0 < info["registers"] <= 255


def _ablate_case(B, L, span_l=True):
    """W=4 windows of at least two blocks, about 3 reads starting per
    position, reads of span 1 where each window starts (so noroll emits and
    its cur drifts across the kernel's chunks), every fifth code moved to
    span L unless ``span_l`` is false: ``(packed, counts, target)`` numpy."""
    n = max(1000 * L // 64, 1000 * B // 128)
    rng = np.random.default_rng(3)
    start = np.sort(rng.integers(0, n - L, 3 * n))
    end = start + rng.integers(0, L - 1, 3 * n)
    one = np.repeat(np.arange(4) * (-(-n // (4 * B)) * B), 2)
    start, end = np.concatenate([start, one]), np.concatenate([end, one])
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, 4, B, L,
                                                         cap_multiple=128)
    packed = np.array(packed)
    assert packed.shape[0] >= 2
    if span_l:
        sel = (packed >= 0) & (np.arange(packed.size).reshape(packed.shape) % 5 == 0)
        packed[sel] = (packed[sel] // L) * L + L - 1
        assert sel.sum() > 10
    return packed, np.array(counts), _native.capped_target(
        start, end, n_pad, 5).reshape(4, win)


@pytest.mark.parametrize("mode", ablate.MODES)
@pytest.mark.parametrize("B,L", [(128, 32), (128, 64), (128, 128), (128, 256), (192, 64),
                                 (256, 32), (256, 64), (256, 128), (256, 256)])
def test_ablate_kernel_matches_plain(cuda, B, L, mode):
    # L=256, B=128 is the default's geometry; B above 128 cuts each block
    # in two chunks, so noroll's re-sync falls inside a block's second one
    packed, _, target = _ablate_case(B, L)
    p, t = torch.tensor(packed, device=cuda), torch.tensor(target, device=cuda)
    n0 = ablate.blocked_ablate.launches
    got = ablate.blocked_ablate(p, t, 4, B, L, mode)
    torch.cuda.synchronize()
    assert ablate.blocked_ablate.launches == n0 + 1
    ref = ablate.blocked_ablate_plain(p, t, 4, B, L, mode)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert mode not in ("full", "noroll") or ref[0].any()


@pytest.mark.parametrize("B,L", [(128, 64), (128, 256), (256, 256)])
def test_ablate_full_equals_kernel_b(cuda, B, L):
    # spans below L: the ablation's full computes kernel B's function
    packed, counts, target = _ablate_case(B, L, span_l=False)
    p, c, t = (torch.tensor(x, device=cuda) for x in (packed, counts, target))
    z = torch.zeros((4, L), dtype=torch.int32, device=cuda)
    got = ablate.blocked_ablate(p, t, 4, B, L, "full")
    ref = blocked.blocked_sweep_pass(p, c, t, z, z, 4, B, L)
    torch.cuda.synchronize()
    for g, r in zip(got, ref[:3]):
        assert torch.equal(g, r)
    assert got[0].any() and got[2].any()


@pytest.mark.parametrize("hot", [65_535, 65_536])
def test_ablate_kernel_takes_65535_starts_at_one_position_and_refuses_more(cuda, hot):
    # one group of cap = 65,536 slots, hot reads of span 5 starting at
    # position 3, the rest pads
    packed = torch.full((1, 2, 65_536), -1, dtype=torch.int32)
    packed[0, 0, :hot] = 3 * 64 + 4
    p = packed.to(cuda)
    t = torch.full((2, 128), 7, dtype=torch.int32, device=cuda)
    if hot > 65_535:
        n0 = ablate.blocked_ablate.launches
        with pytest.raises(ValueError, match="at most 65535 reads"):
            ablate.blocked_ablate(p, t, 2, 128, 64, "full")
        assert ablate.blocked_ablate.launches == n0
        return
    for mode in ("full", "addonly"):
        got = ablate.blocked_ablate(p, t, 2, 128, 64, mode)
        torch.cuda.synchronize()
        ref = ablate.blocked_ablate_plain(p, t, 2, 128, 64, mode)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert int(got[1].sum()) == 65_535


@pytest.mark.parametrize("B", [2, 128, 256])
@pytest.mark.parametrize("mode", ablate.MODES)
@pytest.mark.parametrize("L", [32, 64, 128, 256])
def test_ablate_geometry_and_no_spill(cuda, L, mode, B):
    info = ablate.kernel_info(B, L, mode)
    assert info["chunk_positions"] == ablate.chunk_positions(B)
    assert info["shared_bytes"] == ablate.shared_bytes(B, L)
    assert info["local_bytes"] == 0 and 0 < info["registers"] <= 255


def test_variant_and_ablate_kernels_reject_what_they_do_not_take(cuda):
    r = torch.zeros((16, 48), dtype=torch.int32, device=cuda)
    t = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="max_span in"):
        variants.sweep_variant_c(r, t, 48)
    with pytest.raises(ValueError, match="max_span in"):
        variants.sweep_variant_b(r, t, 48)
    # 65,536 reads of a window starting at one position: the arrival
    # tile's uint16 counts
    with pytest.raises(ValueError, match="tile"):
        ablate.blocked_ablate(
            torch.full((1, 2, 65_536), 5, dtype=torch.int32, device=cuda),
            torch.zeros((2, 128), dtype=torch.int32, device=cuda), 2, 128, 64, "full")
    p = torch.full((1, 2, 128), -1, dtype=torch.int32, device=cuda)
    # a device that is neither CPU nor CUDA: no silent twin
    with pytest.raises(ValueError, match="no sweep variant"):
        variants.sweep_variant_c(torch.zeros((16, 32), dtype=torch.int32, device="meta"),
                                 t.to("meta"), 32)
    with pytest.raises(ValueError, match="no ablation kernel"):
        ablate.blocked_ablate(p.to("meta"), torch.zeros((2, 128), dtype=torch.int32,
                                                        device="meta"), 2, 128, 64, "full")


def test_push_relabel_cuda_equals_cpu_at_the_3000_base_cut(cuda):
    """quasi-mcp-flow-cuda's program on the card (torch ops, no hand
    kernel yet) against the same program on the CPU, at the 3,000-base cut
    of config-1 (2,508 pairs, M=100): read set and every count equal."""
    from genome_downsampler_tpu_torch.solvers.push_relabel import QuasiMcpPushRelabelSolver

    batch = rand_reads_uniform(np.random.default_rng(12345), 2_508, 3_000, 150)
    on_card, on_cpu = QuasiMcpPushRelabelSolver(cuda), QuasiMcpPushRelabelSolver("cpu")
    np.testing.assert_array_equal(on_card.solve(100, batch), on_cpu.solve(100, batch))
    keys = ("supersteps", "bodies", "global_relabels", "closure_rounds", "host_syncs")
    assert ({k: on_card.last_stats[k] for k in keys}
            == {k: on_cpu.last_stats[k] for k in keys})


def test_mesh_engines_over_nccl_at_world_size_one(cuda):
    """The blocked mesh at world size 1 over NCCL (its carries and flags on
    the card) equals ``blocked_windowed_sweep``'s sel at a config-4-shaped
    input (300x over 100 kb, M=50; W=8, B=128, L=256), one kernel B pass a
    round; the dense mesh equals kernel A on the whole genome in one
    launch; the dry run passes at L=32."""
    import torch.distributed as dist

    from genome_downsampler_tpu_torch.entry import dryrun_multichip
    from genome_downsampler_tpu_torch.parallel.launch import (
        global_window_mesh,
        initialize_distributed,
    )
    from genome_downsampler_tpu_torch.parallel.mesh import solve_on_mesh
    from genome_downsampler_tpu_torch.parallel.sharded_io import solve_blocked_on_mesh
    from genome_downsampler_tpu_torch.solvers.device_sweep import _dense_inputs

    n, m, W, B, L = 100_000, 50, 8, 128, 256
    batch = rand_reads_uniform(np.random.default_rng(7), 100_000, n, 150)
    start, end = np.asarray(batch.start, np.int64), np.asarray(batch.end, np.int64)
    packed, counts, win, n_pad, _ = _native.pack_blocked(start, end, n, W, B, L)
    p, c = torch.tensor(packed, device=cuda), torch.tensor(counts, device=cuda)
    t = torch.tensor(_native.capped_target(start, end, n_pad, m).reshape(W, win),
                     device=cuda)
    ref, _ = blocked.blocked_windowed_sweep(p, c, t, W, B, L)
    target, rows = _dense_inputs(batch, n, m, L, cuda)
    z = torch.zeros((1, L), dtype=torch.int32, device=cuda)
    ref_dense = sweep.dense_sweep_counts(rows, target, z, z, L)[0][0]
    assert initialize_distributed(num_processes=1, process_id=0, device=cuda)
    try:
        mesh = global_window_mesh(cuda)
        assert mesh.backend == "nccl" and mesh.wire.type == "cuda"
        b0, a0 = blocked.blocked_sweep_pass.launches, sweep.dense_sweep_counts.launches
        stats = {}
        sel = solve_blocked_on_mesh(mesh, start, end, n, m, W, B, L, stats=stats)
        assert blocked.blocked_sweep_pass.launches - b0 == stats["rounds"] <= W
        np.testing.assert_array_equal(sel, ref.cpu().numpy())
        dense = solve_on_mesh(mesh, start, end, n, m, L)
        assert sweep.dense_sweep_counts.launches - a0 == 1
        np.testing.assert_array_equal(dense, ref_dense.cpu().numpy())
        assert dryrun_multichip(cuda)["max_span"] == 32
    finally:
        dist.destroy_process_group()
