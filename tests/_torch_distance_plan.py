"""A Python copy of the CD and EMD kernels' plans (``csrc/chamfer.cu``,
``csrc/emd.cu``): the route between the whole-pair layout and the
large-cloud one, the whole-pair layout's shared memory and CTAs per pair,
and the large layout's CTAs, chunks and scratch. The CPU tests show with it
that every cloud up to PAIR_POINTS takes the whole-pair layout and fits,
and that the large layout's packed counts hold up to MAX_POINTS; the card
tests hold it to the kernel libraries' own answers. No JAX: the card tests
import it."""

PAIR_POINTS = 4096        # the whole-pair layouts' largest cloud
MAX_POINTS = 16384        # the large layout's
THREADS = 256
SMS = 132
SMEM_LIMIT = 232448
ROWS, COLS, CHUNK = 256, 256, 32   # the Chamfer tiles
FIX_MAX = 64
HIT_PAIR = 8192           # a hit in the whole-pair backward's packed counts
HIT_LARGE = 1 << 15       # in the large layout's
AFF = 1 << 31             # the fix-up's mark
UNIT = 16                 # EMD's padding and cluster split
R = 8                     # points an EMD thread holds
LARGE_SCRATCH_FLOATS = 1 << 26
LARGE_STATE_BYTES = 1 << 28


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def route(n: int, m: int) -> str:
    """"large" where a cloud has more than PAIR_POINTS points, else "pair"."""
    return "large" if n > PAIR_POINTS or m > PAIR_POINTS else "pair"


# ---- the whole-pair layouts

def cd_tiles(n: int, m: int) -> int:
    return _up(n, ROWS) // ROWS * -(-_up(m, CHUNK) // COLS)


def cd_smem(n: int, m: int) -> int:
    """chamfer_kernel: both clouds as float4, the minima as u32."""
    return 16 * (_up(n, ROWS) + _up(m, CHUNK)) + 4 * (n + m)


def bwd_smem(n: int, m: int) -> int:
    """nnd_bwd_kernel: clouds, words, u16 members, bounds."""
    return 16 * (_up(n, ROWS) + _up(m, CHUNK)) + 8 * (n + m) + 4 * (n + _up(m, CHUNK))


def emd_smem(n: int, m: int) -> int:
    """emd_kernel: the larger of exact mode's bytes and fast mode's."""
    np_, mp = _up(n, UNIT), _up(m, UNIT)
    ps = mp // 2 + 8
    exact = 16 * (np_ + mp) + 12 * np_ + 8 * mp + 4 * THREADS * R
    fast = 16 * (np_ + mp) + 10 * np_ + 8 * mp + 12 * ps
    return max(exact, fast)


def cd_cluster(p: int, n: int, m: int) -> int:
    if p >= 2 * SMS:
        return 1
    c = 4 if 4 * p <= SMS else 2
    while c > 1 and cd_tiles(n, m) < c:
        c //= 2
    return c


def emd_cluster(p: int, n: int, m: int) -> int:
    if p >= 2 * SMS:
        return 1
    c = 4 if 4 * p <= SMS else 2
    while c > 1 and -(-min(n, m) // UNIT) < c:
        c //= 2
    return c


# ---- the large layout

def large_ctas(m: int) -> int:
    """CTAs a pair takes in the Chamfer sweeps: one a column tile."""
    return -(-m // COLS)


def cd_large_chunk(p: int, n: int, m: int) -> int:
    """Pairs a chunk of cd_pairwise takes: their minima within 2^26 floats."""
    return max(1, min(p, LARGE_SCRATCH_FLOATS // (n + m)))


def cd_large_scratch_floats(p: int, n: int, m: int) -> int:
    return cd_large_chunk(p, n, m) * (n + m)


def bwd_large_scratch_words(p: int, n: int, m: int) -> int:
    """words and counts [P, N + M], the listed points [P, FIX_MAX], the path
    and their number [P, 2]."""
    return p * (2 * (n + m) + FIX_MAX + 2)


def bwd_large_grids(p: int, n: int, m: int):
    """CTAs of the backward's launches: sweep, classify, count, sums."""
    return (p * large_ctas(m), p, p * -(-(n + m) // THREADS),
            p * (-(-n // THREADS) + -(-m // THREADS)))


def largest_word(n: int, m: int) -> int:
    """The largest packed count of the large backward: every point of the
    other cloud a hit, each at the largest index."""
    k = max(n, m)
    return k * (HIT_LARGE + k - 1)


def emd_state_bytes(n: int, m: int, fast: bool) -> int:
    np_, mp = _up(n, UNIT), _up(m, UNIT)
    ps = mp // 2 + 8
    return _up(8 * mp + 8 * np_ + (12 * ps + 2 * np_ if fast else 4 * np_), 16)


def emd_chunk(p: int, n: int, m: int, fast: bool) -> int:
    return max(1, min(p, LARGE_STATE_BYTES // emd_state_bytes(n, m, fast)))


def emd_own(p: int, n: int, m: int, fast: bool) -> int:
    """Points a CTA of the large EMD sweeps owns: 2048, halved down to 256
    while the chunk's pairs give fewer than 2 x SMS CTAs."""
    q, k, own = emd_chunk(p, n, m, fast), min(n, m), 2048
    while own > 256 and q * -(-k // own) < 2 * SMS:
        own //= 2
    return own


def emd_scratch_bytes(s1: int, s2: int, p: int, n: int, m: int, n_iters: int, fast: bool) -> int:
    q, own = emd_chunk(p, n, m, fast), emd_own(p, n, m, fast)
    clouds = 16 * (s1 * _up(n, UNIT) + s2 * _up(m, UNIT))
    return clouds + _up(4 * q * n_iters * -(-m // own), 16) + q * emd_state_bytes(n, m, fast)
