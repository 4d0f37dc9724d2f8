"""Inputs that stress the kNN kernels K1 and K2, where each row's source
sweep is split over several lanes and the lanes' lists are merged: orders,
exact ties, masked twins, tiny source counts and shapes that straddle the
split. numpy only: the CPU parity tests, the card tests and
``chip_smoke.py`` build their inputs from these one definitions."""
import numpy as np

ROWS = 37        # off any block, warp or tile size


def _rng(name, k):
    return np.random.default_rng([sum(map(ord, name)), k])


def scan_approach(k, rows=ROWS):
    """Sources on a ray, each nearer every query than the one before it
    (queries within 0.1 of the origin, sources at 1 + 0.01 (N - j) along
    one direction): every source beats the k-th best when it arrives."""
    rng = _rng("scan", k)
    u = np.array([0.48, 0.6, 0.64], np.float32)
    t = 1.0 + 0.01 * np.arange(300, 0, -1, dtype=np.float32)
    s = (t[:, None] * u[None, :]).astype(np.float32)
    q = rng.uniform(-0.05, 0.05, size=(rows, 3)).astype(np.float32)
    return q, s, np.ones(len(s), bool)


def all_identical(k, rows=ROWS):
    """Every source the same point: every distance ties, so the indices
    are 0..k-1."""
    rng = _rng("same", k)
    s = np.repeat(rng.normal(size=(1, 3)).astype(np.float32), 100, 0)
    q = rng.normal(size=(rows, 3)).astype(np.float32)
    return q, s, np.ones(len(s), bool)


def masked_twin(k, rows=ROWS):
    """Each odd source has a masked copy just before it; the queries sit on
    the odd sources, so the nearest is the valid twin at distance 0."""
    rng = _rng("twin", k)
    s = rng.normal(size=(120, 3)).astype(np.float32)
    s[0::2] = s[1::2]
    m = np.ones(len(s), bool)
    m[0::2] = False
    return s[1::2][:rows].copy(), s, m


def _random(k, n, name, rows=ROWS, masked=0.25):
    rng = _rng(name, k)
    q = rng.normal(size=(rows, 3)).astype(np.float32)
    s = rng.normal(size=(n, 3)).astype(np.float32)
    m = rng.uniform(size=n) >= masked
    m[0] = True                                  # at least one valid source
    return q, s, m


def one_source(k, rows=ROWS):
    return _random(k, 1, "one", rows)


def fewer_than_k(k, rows=ROWS):
    """N = k - 1 sources (N = 1 at k = 2)."""
    return _random(k, max(1, k - 1), "few", rows)


def n33(k, rows=ROWS):
    """N = 33: one above a 32-lane split, one above k = 32."""
    return _random(k, 33, "n33", rows)


# name -> case(k) -> (query f32[M, 3], source f32[N, 3], mask bool[N])
CASES = {f.__name__: f for f in (scan_approach, all_identical, masked_twin,
                                 one_source, fewer_than_k, n33)}

# shapes that straddle the split: M around a warp, N below, at and one above
# a 32-lane split, k = 32 (M, N, k, masked share)
STRADDLE = [(1, 31, 2, 0.0), (1, 33, 32, 0.0), (31, 32, 16, 0.25),
            (33, 33, 32, 0.25), (33, 31, 8, 0.0), (31, 2560, 32, 0.0),
            (16384, 16384, 30, 0.9)]


def straddle(M, N, k, masked):
    """Random points at one ``STRADDLE`` shape: (query, source, mask)."""
    rng = np.random.default_rng([M, N, k])
    q = rng.normal(size=(M, 3)).astype(np.float32)
    s = rng.normal(size=(N, 3)).astype(np.float32)
    return q, s, rng.uniform(size=N) >= masked


def _pad_sources(s, m, n):
    """(s, m) padded to n sources with masked copies of source 0."""
    pad = n - len(s)
    return (np.concatenate([s, np.repeat(s[:1], pad, 0)]),
            np.concatenate([m, np.zeros(pad, bool)]))


def batches():
    """Inputs of K1's batch mode: name -> (query f32[B, M, 3], source
    f32[B, N, 3], mask bool[B, N]). The single-launch cases above stacked
    into one batch (their sources padded to a common N with masked points),
    an entry with no valid source between two that have some, B = 1, masks
    that differ per entry from none masked to one source left, and B · M
    around the row counts at which the lanes per row change."""
    out = {}
    stacked = [c(1) for c in (scan_approach, all_identical, masked_twin, n33)]
    n = max(len(s) for _, s, _ in stacked)
    padded = [(q,) + _pad_sources(s, m, n) for q, s, m in stacked]
    out["stacked_cases"] = tuple(np.stack(x) for x in zip(*padded))
    rng = np.random.default_rng(2024)

    def rand(B, M, N, shares):
        q = rng.normal(size=(B, M, 3)).astype(np.float32)
        s = rng.normal(size=(B, N, 3)).astype(np.float32)
        m = rng.uniform(size=(B, N)) >= np.asarray(shares)[:, None]
        return q, s, m

    out["entry_without_valid_source"] = rand(3, 70, 100, [0.2, 1.0, 0.2])
    out["one_entry"] = rand(1, 129, 1100, [0.1])
    q, s, m = rand(4, 65, 1500, [0.0, 0.25, 0.9, 1.0])
    m[3, 777] = True                             # one source left
    out["masks_differ"] = (q, s, m)
    out["many_entries"] = rand(48, 100, 70, np.linspace(0.0, 0.9, 48))
    out["rows_fill_the_card"] = rand(8, 8200, 257, [0.3] * 8)
    return out
