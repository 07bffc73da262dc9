"""The plain reference: what a selection of a sample's reads must achieve,
worked out from the reads alone with numpy and scipy.

It imports nothing of the program and takes nothing the program made: the
target, the least read count and the least QMCP cost all come from the
sample's ``start``, ``end`` and ``quality`` arrays (``generate.sample``).

- ``target``: ``min(coverage in, M)`` at each base, the guarantee every
  solver gives (``coverage out >= target``).
- ``least_reads``: the fewest reads that meet the target, by the greedy
  that at each base, left to right, takes the missing reads among those
  that cover it with the furthest ends (optimal for covering points with
  intervals); reads with equal ``(start, end)`` are counted together, and
  ``least_selection`` names such reads.
- ``least_cost``: the least ``sum(max_q - q + 1)`` that meets the target,
  as the min-cost flow the QMCP is (read arcs ``start -> end + 1`` of
  capacity 1, chain arcs ``i + 1 -> i`` free, node supplies the target's
  steps), solved as a linear program by HiGHS's dual simplex; the network
  matrix makes its vertex integral, and the solution is checked exactly.
"""

from __future__ import annotations

import heapq

import numpy as np


def coverage(start, end, n: int, keep=None) -> np.ndarray:
    """Reads covering each base ``0..n-1`` (int64); ``keep`` selects reads."""
    s = np.asarray(start, np.int64)
    e = np.asarray(end, np.int64)
    if keep is not None:
        s, e = s[keep], e[keep]
    ok = e >= s
    d = (np.bincount(np.clip(s[ok], 0, n), minlength=n + 1)
         - np.bincount(np.clip(e[ok] + 1, 0, n), minlength=n + 1))
    return np.cumsum(d[:n])


def target(sample: dict, m: int) -> np.ndarray:
    return np.minimum(coverage(sample["start"], sample["end"], sample["genome_length"]), m)


def costs(sample: dict) -> np.ndarray:
    """Each read's QMCP cost ``max_q - q + 1``, ``max_q`` the sample's."""
    q = np.asarray(sample["quality"], np.int64)
    return int(q.max(initial=0)) - q + 1


def least_reads(sample: dict, t: np.ndarray) -> int:
    return int(least_takes(sample, t)[1].sum())


def least_takes(sample: dict, t: np.ndarray):
    """``(bucket, take)``: each read's ``(start, end)`` bucket (-1 for a read
    that covers no base) and how many of each bucket the greedy takes."""
    n = sample["genome_length"]
    s = np.asarray(sample["start"], np.int64)
    e = np.minimum(np.asarray(sample["end"], np.int64), n - 1)
    ok = (e >= s) & (s < n)
    key, inv, count = np.unique(s[ok] * n + e[ok], return_inverse=True, return_counts=True)
    bucket = np.full(s.shape[0], -1, np.int64)
    bucket[ok] = inv
    bstart, bend = key // n, key % n
    take = np.zeros(len(key), np.int64)
    heap: list = []
    expire = np.zeros(n + 1, np.int64)
    cur = k = 0
    for b in range(n):
        while k < len(key) and bstart[k] <= b:
            heapq.heappush(heap, (-int(bend[k]), k))
            k += 1
        cur += expire[b]
        need = int(t[b]) - cur
        while need > 0:
            neg_end, j = heapq.heappop(heap)
            if -neg_end < b:
                continue
            got = min(int(count[j] - take[j]), need)
            take[j] += got
            need -= got
            cur += got
            expire[-neg_end + 1] -= got
            if take[j] < count[j]:
                heapq.heappush(heap, (neg_end, j))
    return bucket, take


def least_selection(sample: dict, t: np.ndarray) -> np.ndarray:
    """A least-count selection meeting ``t``: each bucket's first reads by
    index, as many as the greedy takes; quality plays no part."""
    bucket, take = least_takes(sample, t)
    idx = np.flatnonzero(bucket >= 0)
    idx = idx[np.argsort(bucket[idx], kind="stable")]
    b = bucket[idx]
    first = np.searchsorted(b, np.arange(len(take)))
    rank = np.arange(len(idx)) - first[b]
    return np.sort(idx[rank < take[b]])


def least_cost(sample: dict, t: np.ndarray) -> int:
    from scipy.optimize import linprog
    from scipy.sparse import coo_matrix

    n = sample["genome_length"]
    s = np.asarray(sample["start"], np.int64)
    e1 = np.asarray(sample["end"], np.int64) + 1
    c = costs(sample)
    ok = (e1 > s) & (s < n)
    if int(t.max(initial=0)) == 0:
        return 0
    # reads of equal (start, end, cost) form one arc of their count
    key, cap = np.unique(np.stack([s[ok], np.minimum(e1[ok], n), c[ok]]), axis=1,
                         return_counts=True)
    a = key.shape[1]
    # columns: the read arcs, then the chain arcs i + 1 -> i (i < n)
    tails = np.concatenate([key[0], np.arange(1, n + 1)])
    heads = np.concatenate([key[1], np.arange(n)])
    cols = np.arange(a + n)
    incidence = coo_matrix(
        (np.concatenate([np.ones(a + n), -np.ones(a + n)]),
         (np.concatenate([tails, heads]), np.concatenate([cols, cols]))),
        shape=(n + 1, a + n)).tocsr()
    supply = np.diff(np.concatenate([[0], t, [0]]))  # out - in at node v
    cost = np.concatenate([key[2], np.zeros(n, np.int64)]).astype(float)
    bounds = np.stack([np.zeros(a + n), np.concatenate([cap, np.full(n, np.inf)])], 1)
    res = linprog(cost, A_eq=incidence, b_eq=supply, bounds=bounds, method="highs-ds")
    if res.status != 0:
        raise RuntimeError(f"reference LP failed: {res.message}")
    x = np.rint(res.x).astype(np.int64)
    if (np.any(x < 0) or np.any(x[:a] > cap)
            or np.any(np.asarray(incidence @ x).ravel().astype(np.int64) != supply)):
        raise RuntimeError("reference LP vertex is not an integral feasible flow")
    return int(x[:a] @ key[2])
