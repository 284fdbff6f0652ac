"""Plain PyTorch versions of the IIR recurrence kernel (S1).

:func:`df2t` is the plain version of the function ``csrc/iir_df2t.cu``
computes: direct form II transposed over the rows of ``x``, with scipy's
``zi``/``zf`` semantics, in the signal's type and in the JAX package's
``_sequential_filter``'s order of operations, one separate multiply or add
at a time:

    y[i]  = b0 * x[i] + s[0]
    s'    = (shift(s) + b[1:] * x[i]) - a[1:] * y[i]

It loops over time, one step for all rows at once; the products of the
input with the coefficients do not depend on the state and are formed for
every sample before the loop.  The kernel wrapper (``kernels.iir_df2t``)
runs it for tensors on the CPU.

:func:`df2t_blocked` models the kernel's own arithmetic, a blocked
parallel-in-time scan over chunks of :data:`CHUNK` samples, operation for
operation, so that the kernel can be held to it bit for bit:

A. each chunk but the last runs the recurrence from a zero state and keeps
   only its end state e[k], in double-double for a float64 signal (in
   plain float64 for a float32 one);
B. the carry: Phi = A^L, the L-step zero-input map of the state, from L
   such steps from each unit state; then s_0 = zi and
   s_k = Phi s_{k-1} + e[k-1], each entry the pairwise sum of (e[k-1]_i,
   Phi_i0 s_0, ..., Phi_i,d-1 s_{d-1}), rounded to the signal's type as
   each chunk's start state S[k].  The K - 1 steps go in two levels of
   groups of CARRY_GROUP steps (carry_groups): each group from a zero
   state, the groups' starts by Psi = Phi^M (M steps from each unit
   state), then each group again from its start;
C. every chunk runs :func:`df2t`'s recurrence, in the signal's type, from
   S[k] (chunk 0 from ``zi``); the last chunk's end state is ``zf``.

Double-double numbers are (hi, lo) pairs of float64 (Dekker; about 106
bits).  TwoProd's error term is a fused multiply-add's on the card and the
same value here, gradual underflow included (:func:`_two_prod`).  The
blocked output is not the
sequential one beyond the first chunk: the carry is more precise than the
sequential recurrence, whose state on a clustered-pole filter amplifies
rounding by ~1e10.  Tests use this model; no user path runs it.
"""

from __future__ import annotations

import torch

__all__ = ['MAX_STATE', 'CHUNK', 'CARRY_GROUP', 'df2t', 'df2t_blocked',
           'carry_matrix', 'carry_groups', 'state_maps', 'shard_carry']

#: the largest state the kernel holds in registers (csrc/iir_df2t.cu
#: IIR_MAX_D)
MAX_STATE = 16

#: samples per chunk of the blocked scan (csrc/iir_df2t.cu IIR_L)
CHUNK = 512

#: steps a group of the two-level carry (csrc/iir_df2t.cu IIR_B_GROUP)
CARRY_GROUP = 32

_SPLIT = 134217729.0   # 2^27 + 1, Dekker's splitter for float64


def _check_state(d):
    if not 1 <= d <= MAX_STATE:
        raise ValueError(f"the recurrence kernel takes a state of 1 to "
                         f"{MAX_STATE} entries, got {d}")


def df2t(x, coef, zi, y, zf):
    """Filter the rows of ``x`` (R, n) into ``y`` from state ``zi`` (R, d),
    writing the final state to ``zf``; ``coef`` is (2 * (d + 1),), b[0..d]
    then a[0..d] (a[0] = 1, unread).  Returns ``y``; ``y`` None writes the
    final state alone (the same as the full call's)."""
    rows, n = x.shape
    d = zi.shape[1]
    _check_state(d)
    b0, bt, at = coef[0], coef[1:d + 1], coef[d + 2:]
    bx0 = x * b0                     # b0 * x[i], every i
    bx = x[..., None] * bt           # b[1:] * x[i], every i
    zero = torch.zeros((rows, 1), dtype=x.dtype, device=x.device)
    s = zi.clone()
    for i in range(n):
        yn = bx0[:, i] + s[:, 0]
        s = (torch.cat([s[:, 1:], zero], 1) + bx[:, i]) - at * yn[:, None]
        if y is not None:
            y[:, i] = yn
    zf.copy_(s)
    return y


# double-double arithmetic on (hi, lo) pairs of float64 tensors, in the
# kernel's order of operations (csrc/iir_df2t.cu two_sum ... dd_mul)

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    """(p, e): p = a * b rounded, and e = fma(a, b, -p), the kernel's
    ``__fma_rn`` error term, bit for bit.  Dekker's product of the
    mantissas of a and b (``torch.frexp``, in [0.5, 1): no partial product
    underflows) is exact, h + l, and a b = (h + l) 2^S.  Where p is normal
    it is h 2^S, so the error is l 2^S, which ``ldexp`` rounds once, as the
    fused multiply-add does.  Where p is below 2^-1021 the error is at most
    half the subnormal quantum, and both give 0.  (Dekker's split of a and
    b themselves differs from the fused multiply-add wherever a partial
    product underflows, |a b| below ~1e-292.)"""
    p = a * b
    ma, ea = torch.frexp(a)
    mb, eb = torch.frexp(b)
    t = ma * _SPLIT
    ah = t - (t - ma)
    al = ma - ah
    t = mb * _SPLIT
    bh = t - (t - mb)
    bl = mb - bh
    h = ma * mb
    return p, torch.ldexp((((ah * bh - h) + ah * bl) + al * bh) + al * bl,
                          ea + eb)


def _dd_add(x, y):
    s, e = _two_sum(x[0], y[0])
    t, f = _two_sum(x[1], y[1])
    s, e = _fast_two_sum(s, e + t)
    return _fast_two_sum(s, e + f)


def _dd_sub(x, y):
    return _dd_add(x, (-y[0], -y[1]))


def _dd_mul_d(x, c):
    p, e = _two_prod(x[0], c)
    return _fast_two_sum(p, e + x[1] * c)


def _dd_mul(x, y):
    p, e = _two_prod(x[0], y[0])
    return _fast_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def _dd_walk(x, coef, s):
    """The recurrence over the columns of ``x`` (R, m) float64 in
    double-double from the state ``s`` ((R, d), (R, d)) -> the end
    state."""
    d = s[0].shape[1]
    b0, bt, at = coef[0], coef[1:d + 1], coef[d + 2:]
    for i in range(x.shape[1]):
        xn = x[:, i]
        yh, yl = _dd_add(_two_prod(b0, xn), (s[0][:, 0], s[1][:, 0]))
        th, tl = _two_prod(bt, xn[:, None])              # b[j+1] x
        if d > 1:                                        # + s[j+1]
            hh, ll = _dd_add((s[0][:, 1:], s[1][:, 1:]),
                             (th[:, :d - 1], tl[:, :d - 1]))
            th = torch.cat([hh, th[:, d - 1:]], 1)
            tl = torch.cat([ll, tl[:, d - 1:]], 1)
        s = _dd_sub((th, tl), _dd_mul_d((yh[:, None], yl[:, None]), at))
    return s


def _tree_sum(terms, add):
    """The kernel's pairwise sum: adjacent terms first, level by level."""
    w = 1
    while w < len(terms):
        for m in range(0, len(terms) - w, 2 * w):
            terms[m] = add(terms[m], terms[m + w])
        w *= 2
    return terms[0]


def _pairs(f, *vs):
    """f over float64 tensors, or over each word of (hi, lo) pairs."""
    if isinstance(vs[0], tuple):
        return tuple(f(*w) for w in zip(*vs))
    return f(*vs)


def _carry_step(s, mat, add):
    """s <- mat s + add over rows of states s, add (R, d) (double-double
    pairs or float64), mat (d, d): entry i the pairwise sum of (add_i,
    mat_i0 s_0, ..., mat_i,d-1 s_{d-1})."""
    dd = isinstance(s, tuple)
    mul, plus = (_dd_mul, _dd_add) if dd else (torch.mul, torch.add)
    d = (s[0] if dd else s).shape[1]
    return _tree_sum([add] + [
        mul(_pairs(lambda m: m[:, j], mat), _pairs(lambda v: v[:, j:j + 1], s))
        for j in range(d)], plus)


def carry_groups(steps):
    """The two-level carry's groups of CARRY_GROUP steps over ``steps`` >= 1
    steps, the last shorter."""
    return -(-steps // CARRY_GROUP)


def _carry(coef, chunk, zi, e):
    """The chunks' start states S[1..K-1] (rows, K-1, d) in zi's type from
    their end states e (rows, K-1, d; double-double pairs or float64): s_0
    = zi, s_k = Phi s_{k-1} + e[k-1], in two levels of groups of M
    steps (carry_groups): each group's end from a zero state (F), the groups'
    starts T_g = Psi T_{g-1} + F[g-1] with Psi = Phi^M (M steps from each
    unit state), then every group's steps from T_g.  One group is the
    plain walk."""
    dd = isinstance(e, tuple)
    rows, steps, d = (e[0] if dd else e).shape
    phi = carry_matrix(coef, chunk)
    s0 = zi.double()
    s0 = (s0, torch.zeros_like(s0)) if dd else s0

    def rnd(v):
        return (v[0] + v[1] if dd else v).to(zi.dtype)

    M, G = CARRY_GROUP, carry_groups(steps)
    if G == 1:
        out = []
        for k in range(steps):
            s0 = _carry_step(s0, phi, _pairs(lambda v: v[:, k], e))
            out.append(rnd(s0))
        return torch.stack(out, 1)
    zero = torch.zeros((1, 1), dtype=torch.float64, device=zi.device)
    zero = (zero, zero) if dd else zero
    eye = torch.eye(d, dtype=torch.float64, device=zi.device)
    u = (eye, torch.zeros_like(eye)) if dd else eye
    for _ in range(M):               # Psi's columns, as rows of u
        u = _carry_step(u, phi, zero)
    psi = _pairs(lambda v: v.T.contiguous(), u)
    pad = _pairs(lambda v: torch.cat([v, v.new_zeros(
        (rows, G * M - steps, d))], 1).reshape(rows, G, M, d), e)
    f = _pairs(lambda v: torch.zeros_like(v[:, :G - 1, 0]).reshape(-1, d),
               pad)
    for m in range(M):               # F: the full groups from zero
        f = _carry_step(f, phi, _pairs(
            lambda v: v[:, :G - 1, m].reshape(-1, d), pad))
    f = _pairs(lambda v: v.reshape(rows, G - 1, d), f)
    t = [s0]
    for g in range(1, G):            # T_g = Psi T_{g-1} + F[g-1]
        t.append(_carry_step(t[-1], psi, _pairs(lambda v: v[:, g - 1], f)))
    s = _pairs(lambda *v: torch.stack(v, 1).reshape(-1, d), *t)
    out = []
    for m in range(M):               # every group's steps from T_g
        s = _carry_step(s, phi, _pairs(lambda v: v[:, :, m].reshape(-1, d),
                                       pad))
        out.append(rnd(s).reshape(rows, G, d))
    return torch.stack(out, 2).reshape(rows, G * M, d)[:, :steps]


def carry_matrix(coef, chunk=CHUNK):
    """Phi = A^chunk of the state, Phi[:, j] the state ``chunk`` zero-input
    steps after the unit state e_j: a (hi, lo) pair of (d, d) float64 for a
    float64 ``coef``, one (d, d) float64 tensor for a float32 one."""
    _check_state((coef.shape[0] - 2) // 2)
    return _pairs(lambda v: v.T.contiguous(), _unit_walk(coef, chunk))


def df2t_blocked(x, coef, zi, y, zf, chunk=CHUNK):
    """:func:`df2t`'s function as the kernel computes it, by chunks of
    ``chunk`` samples (the module's docstring); the same arguments.
    Returns ``y``.  ``y`` None is the kernel's state-only call: A and B,
    then only the last chunk of C, for zf."""
    rows, n = x.shape
    d = zi.shape[1]
    _check_state(d)
    K = max(1, -(-n // chunk))
    starts = torch.empty((rows, K, d), dtype=x.dtype, device=x.device)
    starts[:, 0] = zi
    if K > 1:
        # A: each chunk but the last from a zero state -> e (rows, K-1, d)
        body = x[:, :(K - 1) * chunk].reshape(rows * (K - 1), chunk)
        zero = torch.zeros((rows * (K - 1), d), dtype=torch.float64,
                           device=x.device)
        if x.dtype == torch.float64:
            e = _dd_walk(body, coef, (zero, zero.clone()))
            e = tuple(t.reshape(rows, K - 1, d) for t in e)
        else:
            e = torch.empty_like(zero)
            df2t(body.double(), coef.double(), zero,
                 torch.empty_like(body, dtype=torch.float64), e)
            e = e.reshape(rows, K - 1, d)
        # B: s_k = Phi s_{k-1} + e[k-1], rounded to the signal's type
        starts[:, 1:] = _carry(coef, chunk, zi, e)
    if y is None:                    # C's last chunk alone
        zk = torch.empty((rows, d), dtype=x.dtype, device=x.device)
        df2t(x[:, (K - 1) * chunk:], coef, starts[:, K - 1].clone(), None,
             zk)
        zf.copy_(zk)
        return None
    # C: every chunk in the signal's type from its start state
    full = n // chunk if n % chunk == 0 else K - 1
    ends = torch.empty((rows, K, d), dtype=x.dtype, device=x.device)
    if full:
        m = full * chunk
        yk = torch.empty((rows * full, chunk), dtype=x.dtype,
                         device=x.device)
        zk = torch.empty((rows * full, d), dtype=x.dtype, device=x.device)
        df2t(x[:, :m].reshape(rows * full, chunk), coef,
             starts[:, :full].reshape(rows * full, d), yk, zk)
        y[:, :m] = yk.reshape(rows, m)
        ends[:, :full] = zk.reshape(rows, full, d)
    if full < K:                     # the last chunk, shorter than chunk
        m = full * chunk
        zk = torch.empty((rows, d), dtype=x.dtype, device=x.device)
        df2t(x[:, m:], coef, starts[:, full].clone(), y[:, m:], zk)
        ends[:, full] = zk
    zf.copy_(ends[:, K - 1])
    return y


def _unit_walk(coef, n):
    """The states n zero-input steps after each unit state, as rows (state
    j's in row j): double-double (hi, lo) for a float64 ``coef``, float64
    for a float32 one (:func:`carry_matrix`'s arithmetic)."""
    d = (coef.shape[0] - 2) // 2
    eye = torch.eye(d, dtype=torch.float64, device=coef.device)
    zero = torch.zeros((d, n), dtype=torch.float64, device=coef.device)
    if coef.dtype == torch.float64:
        return _dd_walk(zero, coef, (eye, torch.zeros_like(eye)))
    ends = torch.empty_like(eye)
    df2t(zero, coef.double(), eye, torch.empty_like(zero), ends)
    return ends


def state_maps(coef, lengths) -> dict:
    """Phi(n) = A^n, the state map over n zero-input samples, for each n of
    ``lengths`` -> {n: Phi(n)}, each as :func:`carry_matrix` gives Phi
    (a (hi, lo) pair of (d, d) float64 for a float64 ``coef``, one (d, d)
    float64 for a float32 one).

    Built like the kernel's carry, by steps and never by squaring (powers
    of these companion matrices squared up lose their digits): with n =
    (g * CARRY_GROUP + m) * CHUNK + r, Phi(n) = Psi^g Phi(CHUNK)^m Phi(r),
    Phi(CHUNK) = :func:`carry_matrix`, Psi = Phi(CHUNK)^CARRY_GROUP by
    CARRY_GROUP products, Phi(r) by r steps from each unit state, each
    product a carry step of the states after each unit state."""
    d = (coef.shape[0] - 2) // 2
    _check_state(d)
    dd = coef.dtype == torch.float64
    zero = torch.zeros((1, 1), dtype=torch.float64, device=coef.device)
    zero = (zero, zero) if dd else zero
    phi = carry_matrix(coef, CHUNK)
    psi = None
    maps = {}
    for n in sorted(set(int(v) for v in lengths)):
        q, r = divmod(n, CHUNK)
        g, m = divmod(q, CARRY_GROUP)
        if g and psi is None:
            u = _unit_walk(coef, 0)
            for _ in range(CARRY_GROUP):
                u = _carry_step(u, phi, zero)
            psi = _pairs(lambda v: v.T.contiguous(), u)
        u = _unit_walk(coef, r)
        for mat, k in ((phi, m), (psi, g)):
            for _ in range(k):
                u = _carry_step(u, mat, zero)
        maps[n] = _pairs(lambda v: v.T.contiguous(), u)
    return maps


def shard_carry(coef, zf0, lengths, zi, maps=None):
    """Each time shard's start state from every shard's end state from a
    zero state: the carry of a time-sharded filter across its shards.

    ``zf0`` (R, P, d): shard j's end state from zero over its
    ``lengths[j]`` samples (the last shard's is not read); ``zi`` (R, d)
    the first shard's start state.  -> z_in (R, P, d) in ``zi``'s dtype:

        z_in[:, 0] = zi
        z_in[:, j] = Phi(lengths[j-1]) z_in[:, j-1] + zf0[:, j-1]

    carried in double-double for a float64 ``coef`` (float64 for a float32
    one), entry i of each step the pairwise sum of (zf0_i, Phi_i0 z_0, ...,
    Phi_i,d-1 z_{d-1}) as in the kernel's carry, and rounded to ``zi``'s
    type once a shard.  ``maps`` ({n: Phi(n)}, :func:`state_maps` of
    ``coef`` and ``lengths``) is built here when not given; the steps run on
    ``zf0``'s device."""
    R, P, d = zf0.shape
    dd = coef.dtype == torch.float64
    if maps is None:
        maps = state_maps(coef, lengths[:P - 1])
    dev = zf0.device

    def widen(v):
        v = v.to(device=dev, dtype=torch.float64)
        return (v, torch.zeros_like(v)) if dd else v

    s = widen(zi)
    out = [zi.to(dev)]
    for j in range(1, P):
        phi = _pairs(lambda v: v.to(dev), maps[int(lengths[j - 1])])
        s = _carry_step(s, phi, widen(zf0[:, j - 1]))
        out.append((s[0] + s[1] if dd else s).to(zi.dtype))
    return torch.stack(out, 1)
