"""Batched Montgomery modexp on the card: the port's K7-K10 and K12.

The counterpart of the reference's device functions in
``cleisthenes_tpu/ops/modmath.py:313-732``.  Six entry points, each
with its plain PyTorch version beside it:

- ``mont_mul_batch``     K10, ``mont_mul_batch`` (modmath.py:504)
- ``pow_fused``          K7,  ``_pow_fused`` (:551): rows ordered by
                         exponent length on the card, then a window per
                         warp (``pow_plan`` names the plan a call takes)
- ``dual_pow_fused``     K8,  ``_dual_pow_fused`` (:592)
- ``pow_fused_grouped``  K9,  ``_pow_fused_grouped`` (:639): the
                         fixed-base comb of width ``COMB_WIDTH``, two
                         launches (a table per base, then one thread per
                         exponent, which names its base by a row index)
- ``wide_pow_fused``,    K12, ``_wide_kernels(lay)`` (:313) -> its
  ``wide_dual_pow_fused``  ``pow_fused`` (:351) and ``dual_pow_fused``
                         (:378) for groups of 257 to 2112 bits
                         (csrc/modexp_wide.cu: a team of lanes per
                         exponentiation)

The byte contract is the reference's: values are (B, 33) uint8
little-endian rows (a base may lie anywhere in [0, 2^264)), exponents
(B, 32) uint8 big-endian rows, results (B, 33) rows in [0, p).  The
group rides in as a ``MontSpec`` (``mont_spec(p)``), the counterpart of
the reference's ``_spec256``: any odd modulus of 256 bits or fewer.
The wide entry points take the reference's wide byte contract: values
(B, val_bytes) little-endian rows already reduced mod p, exponents
(B, val_bytes) big-endian rows, for the 48-, 99- and 264-byte families
(``wide_spec(p, val_bytes)``, the counterpart of ``_spec_wide``).

K10 differs from the reference in its radix.  The reference's
``mont_mul_batch`` takes (B, 22) 12-bit limbs and returns
x*y*2^-264 mod p; the port's takes 33-byte values x, y in [0, 2^264)
and returns x*y*2^-256 mod p in [0, p) (csrc/modexp.cu keeps 8 x 32-bit limbs, so
R = 2^256).  The two agree on integer semantics:
out * 2^256 == x * y == ref_out * 2^264 (mod p).

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel (csrc/modexp.cu, csrc/modexp_wide.cu) or
raises.  The plain versions work in int64 with L limbs of 16 bits and
their own radix 2^(16 L) — L = 17 for the 256-bit kernels, one limb
past the value's width for a wide family — whose headroom over p lets
every product skip the conditional subtract: a product's limbs are
normalised by whole-tensor carry passes, and only the final result is
reduced to [0, p).  Only their outputs need to match the kernels', so
the plain pows use a 4-bit fixed window from the batch's first nonzero
exponent nibble.  ``pow_fused_plain`` and ``dual_pow_fused_plain``
take a ``MontSpec`` or a ``WideSpec``: they are the plain versions of
both K7/K8 and K12.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from cleisthenes_tpu_torch.csrc import build as _kb
from cleisthenes_tpu_torch.ops.sha256_cuda import _on_cuda

# the kernels' radix (8 x 32-bit limbs)
KERNEL_R_BITS = 256

# the plain versions' limbs: W bits each; the 256-bit kernels' plain
# versions use L = 17 limbs, radix 2^(W*L) = 2^272
_W = 16
_L = 17
_MASK = (1 << _W) - 1
COMB_ROWS = 64  # nibble positions of a 256-bit exponent (the plain comb)
COMB_COLS = 16  # nibble values
# K7's counting sort (csrc/modexp.cu ``kSortWords``): the key histogram and
# cursors (257 bit lengths each) and a ticket, after the B-row permutation
POW_SORT_WORDS = 515
# rows an SM of PowSmallPlan holds (its MIN_BLOCKS x TEAMS): ``pow_fused``
# takes that plan for a call of at most this many rows an SM
POW_SMALL_ROWS_PER_SM = 16 * 8
# whether a K7 plan orders its rows by exponent length first (and so takes
# the workspace): a call of one wave lasts as long as its longest row in
# any order
POW_ORDERED = {"PowPlan": True, "PowSmallPlan": False}
# The kernels' comb (csrc/modexp.cu ``CombPlan``): digits of COMB_WIDTH bits,
# so a base's table holds ceil(256 / COMB_WIDTH) rows of 2^COMB_WIDTH entries
COMB_WIDTH = 7
# The port's one table of the wide families (csrc/modexp_wide.cu), value
# bytes -> 32-bit words: moduli of at most 384, 792 and 2112 bits (the
# reference's (12, 32), (11, 72) and (11, 192) limb families,
# modmath.py:177-310, by their byte widths).
WIDE_WORDS = {48: 12, 99: 25, 264: 66}


@dataclasses.dataclass(frozen=True)
class MontSpec:
    """Montgomery constants of one odd modulus p < 2^256.

    ``words`` is the kernels' argument: 33 uint32 (p, -p^-1 mod 2^32,
    R mod p, R^2 mod p, R^3 mod p, each 8 little-endian words,
    R = 2^256).  The plain versions' constants (radix 2^272) are built
    per device by ``_plain_consts``."""

    p: int
    words: np.ndarray = dataclasses.field(compare=False, repr=False)
    val_bytes = 33  # value rows (264-bit capacity)
    plain_limbs = _L

    @functools.cached_property
    def ptr(self) -> int:
        """The address of ``words``, read once (a launch's argument)."""
        return self.words.ctypes.data


@dataclasses.dataclass(frozen=True)
class WideSpec:
    """Montgomery constants of one odd modulus in a wide family.

    ``words`` is the kernels' argument: 3 nw + 1 uint32 (p, -p^-1 mod
    2^32, R mod p, R^2 mod p, each nw little-endian words,
    R = 2^(32 nw)).  Values and exponents are ``val_bytes`` rows; the
    plain versions use ``plain_limbs`` 16-bit limbs, one past the
    value's width (radix 2^(16 plain_limbs) > 2^16 p)."""

    p: int
    val_bytes: int
    words: np.ndarray = dataclasses.field(compare=False, repr=False)

    @property
    def nw(self) -> int:
        return WIDE_WORDS[self.val_bytes]

    @functools.cached_property
    def ptr(self) -> int:
        """The address of ``words``, read once (a launch's argument)."""
        return self.words.ctypes.data

    @property
    def plain_limbs(self) -> int:
        return (self.val_bytes + 1) // 2 + 1


def _words(x: int, n: int) -> list:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def _spec_words(p: int, nw: int, powers: int) -> np.ndarray:
    """The kernels' constants of odd ``p`` with nw 32-bit words: p,
    -p^-1 mod 2^32, then R^k mod p for k = 1..powers (R = 2^(32 nw)),
    each nw little-endian words; read-only."""
    r = 1 << (32 * nw)
    words = _words(p, nw) + [(-pow(p, -1, 1 << 32)) % (1 << 32)]
    for k in range(1, powers + 1):
        words += _words(pow(r, k, p), nw)
    out = np.array(words, dtype=np.uint32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def mont_spec(p: int) -> MontSpec:
    """The MontSpec of modulus ``p``; raises for an even modulus or one
    wider than 256 bits (no CUDA layout hosts it yet)."""
    if p % 2 == 0 or p < 3 or p.bit_length() > KERNEL_R_BITS:
        raise ValueError(
            f"modulus of {p.bit_length()} bits (odd={p % 2 == 1}): the "
            "CUDA Montgomery kernels take odd moduli of at most 256 bits"
        )
    return MontSpec(p=p, words=_spec_words(p, KERNEL_R_BITS // 32, 3))


@functools.lru_cache(maxsize=None)
def wide_spec(p: int, val_bytes: int) -> WideSpec:
    """The WideSpec of odd modulus ``p`` in the family of ``val_bytes``
    (48, 99 or 264) byte rows; raises when the family does not host p."""
    nw = WIDE_WORDS.get(val_bytes)
    if nw is None or p % 2 == 0 or p < 3 or p.bit_length() > 8 * val_bytes:
        raise ValueError(
            f"modulus of {p.bit_length()} bits (odd={p % 2 == 1}) does not "
            f"fit a wide family of {val_bytes}-byte values "
            f"(families: {sorted(WIDE_WORDS)})"
        )
    return WideSpec(p=p, val_bytes=val_bytes, words=_spec_words(p, nw, 2))


def family_bytes(p: int) -> Optional[int]:
    """The value bytes of the smallest CUDA family that hosts odd modulus
    ``p``: 33 (``MontSpec``, K7-K10) for at most 256 bits, else 48, 99 or
    264 (``WideSpec``, K12) for at most 8 x that many bits; None for an
    even modulus or one wider than 2112 bits.  Unlike the reference's
    256-bit layout, the 33-byte family takes no 257- to 264-bit modulus
    (csrc/modexp.cu's R is 2^256): those go to the 48-byte one."""
    if p % 2 == 0 or p < 3:
        return None
    if p.bit_length() <= KERNEL_R_BITS:
        return MontSpec.val_bytes
    return next((vb for vb in WIDE_WORDS if p.bit_length() <= 8 * vb), None)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _limbs(x: int, n: int) -> list:
    return [(x >> (_W * i)) & _MASK for i in range(n)]


@functools.lru_cache(maxsize=None)
def _plain_consts(p: int, device: torch.device, nlimbs: int = _L) -> dict:
    """Constants of the plain Montgomery product with ``nlimbs`` limbs
    (radix R = 2^(16 nlimbs), 2^272 for the 256-bit kernels) on one
    device: p's limbs, the Toeplitz matrices (float64, see ``_mont``)
    that multiply by -p^-1 mod R (low half) and by p, R mod p,
    R^2 mod p, and 2^288 mod p (which turns a radix-2^272 product into
    the K10 kernel's 2^-256)."""
    n = nlimbs
    r = 1 << (_W * n)
    pl = _limbs(p, n)
    pinv = _limbs((-pow(p, -1, r)) % r, n)
    t_pinv = torch.zeros((n, n), dtype=torch.float64)
    t_p = torch.zeros((n, 2 * n - 1), dtype=torch.float64)
    for i in range(n):
        for k in range(i, n):
            t_pinv[i, k] = pinv[k - i]
        for j in range(n):
            t_p[i, i + j] = pl[j]

    def vec(x: int) -> torch.Tensor:
        return torch.tensor(_limbs(x, n), dtype=torch.int64, device=device)

    return {
        "L": n,
        "p": vec(p),
        "t_pinv": t_pinv.to(device),
        "t_p": t_p.to(device),
        "one": vec(r % p),
        "r2": vec(r * r % p),
        "c288": vec((1 << 288) % p),
        "unit": vec(1),
    }


def _carry(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Whole-tensor carry passes over the last (limb) axis: each limb
    keeps its low 16 bits and hands the rest to the next; the top
    limb's carry is dropped (callers either work mod R or know it is
    zero)."""
    for _ in range(passes):
        c = x >> _W
        x = x & _MASK
        x[..., 1:] += c[..., :-1]
    return x


def _mont(a: torch.Tensor, b: torch.Tensor, c: dict) -> torch.Tensor:
    """a * b / R mod p, up to a multiple of p, for R = 2^(16 L) > 2^16 p:
    (..., L) int64 limbs below 2^17 in and out.  The output is below
    a*b/R + 1.01p, so inputs below 1.1p (or one below 2^(16 L - 8) and
    the other below p) give an output below 1.1p: products chain
    without a conditional subtract.

    Bounds, for L <= 133 (the 2112-bit family): limb products < 2^34,
    column sums t < 2^41.1; t's low half is carried to limbs < 2^17
    first, so m's columns stay < 2^40.1 and three carry passes leave
    m < 1.01 R; S = t + m*p < 2^42.  The division by R is exact: the
    low half of S is k*R, and k is ceil((S[L-1] * 2^16 + S[L-2]) /
    2^32), since the lower columns add less than 2^-6 to that
    quotient.

    The three limb products run as float64 matrix products: every
    operand is an integer below 2^17 and every partial sum an integer
    below 2^42, so float64 holds them exactly, in any summation order.
    a*b is a product of b's sliding windows with a reversed."""
    n = c["L"]
    win = torch.nn.functional.pad(b.double(), (n - 1, n - 1)).unfold(-1, n, 1)
    t = torch.matmul(win, a.double().flip(-1).unsqueeze(-1)).squeeze(-1).long()
    lo = _carry(t[..., :n], 3)  # t mod R, limbs < 2^17
    m = _carry(torch.matmul(lo.double(), c["t_pinv"]).long(), 3)  # -t/p mod R
    s = t + torch.matmul(m.double(), c["t_p"]).long()
    k = (s[..., n - 1] * (1 << _W) + s[..., n - 2] + ((1 << 32) - 1)) >> 32
    u = torch.nn.functional.pad(s[..., n:], (0, 1))
    u[..., 0] += k
    return _carry(u, 2)


def _bytes_to_limbs(b: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """(..., nb) uint8 little-endian, nb <= 2 nlimbs -> (..., nlimbs)
    int64 16-bit limbs."""
    x = torch.nn.functional.pad(b.to(torch.int64), (0, 2 * nlimbs - b.shape[-1]))
    x = x.reshape(*b.shape[:-1], nlimbs, 2)
    return x[..., 0] | (x[..., 1] << 8)


def _limbs_to_bytes(x: torch.Tensor, c: dict, nbytes: int) -> torch.Tensor:
    """(B, L) limbs of a value below 2p -> (B, nbytes) uint8 of its
    residue in [0, p): one sequential carry, one conditional
    subtract (once per call, so the per-limb loops are cheap)."""
    n = c["L"]
    x = x.clone()
    for i in range(n - 1):
        x[:, i + 1] += x[:, i] >> _W
        x[:, i] &= _MASK
    d = x - c["p"]
    for i in range(n - 1):
        d[:, i + 1] += d[:, i] >> _W  # arithmetic shift: floor borrow
        d[:, i] &= _MASK
    x = torch.where(d[:, n - 1 :] >= 0, d, x)
    out = torch.stack([x & 0xFF, x >> 8], -1).reshape(x.shape[0], 2 * n)
    return out[:, :nbytes].to(torch.uint8)


def _nibbles_msb(e: torch.Tensor) -> torch.Tensor:
    """(B, nb) big-endian exponent bytes -> (B, 2 nb) int64 nibbles,
    most significant first."""
    e = e.to(torch.int64)
    return torch.stack([e >> 4, e & 15], -1).reshape(e.shape[0], -1)


def _to_mont(b: torch.Tensor, c: dict) -> torch.Tensor:
    """(B, nb) values below 2^(8 nb) -> Montgomery-domain limbs."""
    x = _bytes_to_limbs(b, c["L"])
    return _mont(x, c["r2"].expand_as(x), c)


def _from_mont(x: torch.Tensor, c: dict, nbytes: int) -> torch.Tensor:
    return _limbs_to_bytes(_mont(x, c["unit"].expand_as(x), c), c, nbytes)


def _powers16(x: torch.Tensor, c: dict) -> torch.Tensor:
    """(B, 17) Montgomery x -> (B, 16, 17): x^0 .. x^15, in four
    product calls (doubling)."""
    one = c["one"].expand_as(x)
    pw = [one, x]
    while len(pw) < COMB_COLS:
        top = pw[-1]
        want = min(len(pw) - 1, COMB_COLS - len(pw))
        lhs = torch.cat([top] * want, 0)
        rhs = torch.cat(pw[1 : 1 + want], 0)
        pw.extend(_mont(lhs, rhs, c).split(x.shape[0], 0))
    return torch.stack(pw, 1)


def _pow_mont(x: torch.Tensor, e: torch.Tensor, c: dict) -> torch.Tensor:
    """x^e in the Montgomery domain by a 4-bit fixed window from the
    batch's first nonzero nibble: x (B, L) Montgomery limbs, e (B, nb)
    big-endian exponent bytes."""
    tab = _powers16(x, c)
    nib = _nibbles_msb(e)
    nonzero = (nib != 0).any(0).nonzero()
    first = int(nonzero[0]) if len(nonzero) else nib.shape[1] - 1
    rows = torch.arange(x.shape[0], device=x.device)
    acc = tab[rows, nib[:, first]]
    for k in range(first + 1, nib.shape[1]):
        for _ in range(4):
            acc = _mont(acc, acc, c)
        acc = _mont(acc, tab[rows, nib[:, k]], c)
    return acc


def mont_mul_batch_plain(a: torch.Tensor, b: torch.Tensor, spec: MontSpec) -> torch.Tensor:
    """(B, 33) x, y in [0, 2^264) -> (B, 33) x*y*2^-256 mod p."""
    c = _plain_consts(spec.p, a.device)
    x = _mont(_bytes_to_limbs(a, _L), _bytes_to_limbs(b, _L), c)  # x*y/2^272
    x = _mont(x, c["c288"].expand_as(x), c)  # * 2^288 / 2^272
    return _limbs_to_bytes(x, c, 33)


def pow_fused_plain(base: torch.Tensor, exp: torch.Tensor, spec) -> torch.Tensor:
    """The plain K7 and K12 pow: (B, vb) bases, (B, eb) exponents ->
    (B, vb) base^exp mod p, for a MontSpec (vb = 33, eb = 32) or a
    WideSpec (vb = eb = val_bytes)."""
    vb = spec.val_bytes
    if base.shape[0] == 0:
        return torch.empty((0, vb), dtype=torch.uint8, device=base.device)
    c = _plain_consts(spec.p, base.device, spec.plain_limbs)
    return _from_mont(_pow_mont(_to_mont(base, c), exp, c), c, vb)


def dual_pow_fused_plain(
    u1: torch.Tensor, e1: torch.Tensor, u2: torch.Tensor, e2: torch.Tensor,
    spec,
) -> torch.Tensor:
    """The plain K8 and K12 dual pow: (B, vb) u1, u2 and (B, eb) e1, e2
    -> (B, vb) u1^e1 * u2^e2 mod p, for a MontSpec or a WideSpec."""
    b, vb = u1.shape[0], spec.val_bytes
    if b == 0:
        return torch.empty((0, vb), dtype=torch.uint8, device=u1.device)
    c = _plain_consts(spec.p, u1.device, spec.plain_limbs)
    both = _pow_mont(
        _to_mont(torch.cat([u1, u2]), c), torch.cat([e1, e2]), c
    )
    return _from_mont(_mont(both[:b], both[b:], c), c, vb)


def comb_table_plain(bases: torch.Tensor, spec: MontSpec) -> torch.Tensor:
    """(n, 33) bases -> (n, 64, 16, 17) Montgomery limbs of
    base^(j * 16^k), the plain counterpart of the comb's table."""
    c = _plain_consts(spec.p, bases.device)
    x = _to_mont(bases, c)
    chain = [x]
    for _ in range(COMB_ROWS - 1):
        for _ in range(4):
            x = _mont(x, x, c)
        chain.append(x)
    s = torch.stack(chain, 1)  # (n, 64, 17): base^(16^k)
    n = bases.shape[0]
    return _powers16(s.reshape(n * COMB_ROWS, _L), c).reshape(
        n, COMB_ROWS, COMB_COLS, _L
    )


def pow_fused_grouped_plain(
    bases: torch.Tensor, exps: torch.Tensor, rows: torch.Tensor, spec: MontSpec
) -> torch.Tensor:
    """(n, 33) bases, (M, 32) exponents, (M,) int32 row indices -> (M, 33)
    with out[i] = bases[rows[i]]^exps[i] mod p, by the fixed-base comb."""
    m = exps.shape[0]
    if m == 0:
        return torch.empty((0, 33), dtype=torch.uint8, device=exps.device)
    c = _plain_consts(spec.p, bases.device)
    tab = comb_table_plain(bases, spec).reshape(-1, _L)
    nib = _nibbles_msb(exps)
    row = rows.to(torch.int64) * (COMB_ROWS * COMB_COLS)
    # nibble k (bits [4k, 4k+4)) is column 63 - k of the MSB-first list
    acc = tab[row + nib[:, 63]]
    for k in range(1, COMB_ROWS):
        acc = _mont(acc, tab[row + k * COMB_COLS + nib[:, 63 - k]], c)
    return _from_mont(acc, c, 33)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_bytes(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if (
        t.dtype != torch.uint8
        or t.dim() != len(shape)
        or any(want >= 0 and got != want for got, want in zip(t.shape, shape))
        or not t.is_contiguous()
    ):
        raise ValueError(
            f"{name}: need a contiguous uint8 tensor of shape "
            f"{tuple('*' if s < 0 else s for s in shape)}, got {t.dtype} "
            f"{tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def mont_mul_batch(a: torch.Tensor, b: torch.Tensor, spec: MontSpec) -> torch.Tensor:
    """K10: (B, 33) x, y in [0, 2^264) -> (B, 33) x*y*2^-256 mod p."""
    _check_bytes("mont_mul_batch a", a, (-1, 33))
    _check_bytes("mont_mul_batch b", b, (a.shape[0], 33))
    if not _on_cuda(a, b):
        return mont_mul_batch_plain(a, b, spec)
    out = torch.empty_like(a)
    if a.shape[0]:
        _kb.launch(
            "modexp", "mont_mul", ("mont_mul",), a, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), a.shape[0], spec.ptr,
        )
    return out


def pow_plan(n: int, sms: int) -> str:
    """The plan ``pow_fused`` runs ``n`` rows under on a card of ``sms``
    SMs (csrc/modexp.cu): ``PowSmallPlan`` for a call that one wave of its
    resident blocks holds, ``PowPlan`` for a longer one."""
    return "PowSmallPlan" if n <= sms * POW_SMALL_ROWS_PER_SM else "PowPlan"


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def pow_fused(base: torch.Tensor, exp: torch.Tensor, spec: MontSpec) -> torch.Tensor:
    """K7: (B, 33) bases in [0, 2^264), (B, 32) exponents -> (B, 33)
    base^exp mod p, B < 2^31.  On the card a call of ``PowPlan`` orders
    its rows by exponent length in a workspace of B + ``POW_SORT_WORDS``
    int32 taken from PyTorch's allocator (one entry point: one launch
    count)."""
    _check_bytes("pow_fused base", base, (-1, 33))
    _check_bytes("pow_fused exp", exp, (base.shape[0], 32))
    if not _on_cuda(base, exp):
        return pow_fused_plain(base, exp, spec)
    b = base.shape[0]
    if b >= 1 << 31:
        raise ValueError(f"pow_fused: {b} rows, the kernel takes fewer than 2^31")
    out = torch.empty_like(base)
    if b:
        ws = None
        if POW_ORDERED[pow_plan(b, _sm_count(base.get_device()))]:
            ws = torch.empty(b + POW_SORT_WORDS, dtype=torch.int32, device=base.device)
        _kb.launch(
            "modexp", "pow_fused", ("pow",), base, base.data_ptr(),
            exp.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(), b,
            spec.ptr,
        )
    return out


def dual_pow_fused(
    u1: torch.Tensor, e1: torch.Tensor, u2: torch.Tensor, e2: torch.Tensor,
    spec: MontSpec,
) -> torch.Tensor:
    """K8: (B, 33) u1, u2 and (B, 32) e1, e2 -> (B, 33) u1^e1 * u2^e2 mod p."""
    b = u1.shape[0]
    _check_bytes("dual_pow_fused u1", u1, (-1, 33))
    _check_bytes("dual_pow_fused u2", u2, (b, 33))
    _check_bytes("dual_pow_fused e1", e1, (b, 32))
    _check_bytes("dual_pow_fused e2", e2, (b, 32))
    if not _on_cuda(u1, e1, u2, e2):
        return dual_pow_fused_plain(u1, e1, u2, e2, spec)
    out = torch.empty_like(u1)
    if b:
        _kb.launch(
            "modexp", "dual_pow_fused", ("dual_pow",), u1, u1.data_ptr(),
            e1.data_ptr(), u2.data_ptr(), e2.data_ptr(), out.data_ptr(), b,
            spec.ptr,
        )
    return out


def pow_fused_grouped(
    bases: torch.Tensor, exps: torch.Tensor, rows: torch.Tensor, spec: MontSpec
) -> torch.Tensor:
    """K9: (n, 33) bases, (M, 32) exponents, (M,) int32 row indices in
    [0, n) -> (M, 33) with out[i] = bases[rows[i]]^exps[i] mod p: a comb
    table per base (``comb_table``, ceil(256 / w) rows of 2^w entries of
    32 bytes for the width w = ``COMB_WIDTH``: 148 KiB at w = 7), then one
    thread per exponent (``comb_apply``).  The reference's (n, G) rectangle is
    rows = arange(n).repeat_interleave(G)."""
    n, m = bases.shape[0], exps.shape[0]
    _check_bytes("pow_fused_grouped bases", bases, (-1, 33))
    _check_bytes("pow_fused_grouped exps", exps, (-1, 32))
    if rows.dtype != torch.int32 or tuple(rows.shape) != (m,) or not rows.is_contiguous():
        raise ValueError(
            f"pow_fused_grouped rows: need a contiguous int32 tensor of shape "
            f"({m},), got {rows.dtype} {tuple(rows.shape)}"
        )
    outside = ValueError(f"pow_fused_grouped rows: an index lies outside [0, {n})")
    if m and n == 0:
        raise outside
    if not _on_cuda(bases, exps, rows):
        if m and not bool(((rows >= 0) & (rows < n)).all()):
            raise outside
        return pow_fused_grouped_plain(bases, exps, rows, spec)
    out = torch.empty((m, 33), dtype=torch.uint8, device=exps.device)
    if m == 0:
        return out
    table = torch.empty(
        (n, -(-KERNEL_R_BITS // COMB_WIDTH), 1 << COMB_WIDTH, 8),
        dtype=torch.int32, device=exps.device,
    )
    sites = ("pow_grouped",)
    _kb.launch(
        "modexp", "comb_table", sites, exps, bases.data_ptr(), table.data_ptr(),
        n, spec.ptr,
    )
    # The table build reads no row index, so it goes first and the range
    # check is queued behind it; the check is read back only after the
    # accumulation's launch, which reads clamped indices, never a row
    # outside the table.
    lo_hi = torch.stack(torch.aminmax(rows))
    safe = rows.clamp(0, n - 1)
    _kb.launch(
        "modexp", "comb_apply", sites, exps, exps.data_ptr(), safe.data_ptr(),
        table.data_ptr(), out.data_ptr(), m, spec.ptr,
    )
    lo, hi = lo_hi.tolist()
    if lo < 0 or hi >= n:
        raise outside
    return out


def wide_pow_fused(base: torch.Tensor, exp: torch.Tensor, spec: WideSpec) -> torch.Tensor:
    """K12 pow: (B, val_bytes) bases in [0, p), (B, val_bytes) big-endian
    exponents -> (B, val_bytes) base^exp mod p."""
    vb = spec.val_bytes
    _check_bytes("wide_pow_fused base", base, (-1, vb))
    _check_bytes("wide_pow_fused exp", exp, (base.shape[0], vb))
    if not _on_cuda(base, exp):
        return pow_fused_plain(base, exp, spec)
    out = torch.empty_like(base)
    if base.shape[0]:
        _kb.launch(
            "modexp_wide", "wide_pow_fused", ("wide_pow",), base, base.data_ptr(),
            exp.data_ptr(), out.data_ptr(), base.shape[0], spec.nw,
            spec.ptr,
        )
    return out


def wide_dual_pow_fused(
    u1: torch.Tensor, e1: torch.Tensor, u2: torch.Tensor, e2: torch.Tensor,
    spec: WideSpec,
) -> torch.Tensor:
    """K12 dual pow: (B, val_bytes) u1, u2 in [0, p) and e1, e2 ->
    (B, val_bytes) u1^e1 * u2^e2 mod p.  A warp of the kernel whose rows
    all have e2 = 0 (Lagrange rows, u2^0 = 1) skips the second base's
    table and products; the engine's calls send those rows after the
    CP rows, so they fill whole warps."""
    b, vb = u1.shape[0], spec.val_bytes
    for name, t in (("u1", u1), ("e1", e1), ("u2", u2), ("e2", e2)):
        _check_bytes(f"wide_dual_pow_fused {name}", t, (b, vb))
    if not _on_cuda(u1, e1, u2, e2):
        return dual_pow_fused_plain(u1, e1, u2, e2, spec)
    out = torch.empty_like(u1)
    if b:
        _kb.launch(
            "modexp_wide", "wide_dual_pow_fused", ("wide_dual_pow",), u1, u1.data_ptr(),
            e1.data_ptr(), u2.data_ptr(), e2.data_ptr(), out.data_ptr(), b,
            spec.nw, spec.ptr,
        )
    return out


__all__ = [
    "COMB_COLS",
    "COMB_ROWS",
    "COMB_WIDTH",
    "KERNEL_R_BITS",
    "MontSpec",
    "POW_ORDERED",
    "POW_SMALL_ROWS_PER_SM",
    "POW_SORT_WORDS",
    "comb_table_plain",
    "dual_pow_fused",
    "dual_pow_fused_plain",
    "family_bytes",
    "mont_mul_batch",
    "mont_mul_batch_plain",
    "mont_spec",
    "pow_fused",
    "pow_fused_grouped",
    "pow_fused_grouped_plain",
    "pow_fused_plain",
    "pow_plan",
    "WIDE_WORDS",
    "WideSpec",
    "wide_dual_pow_fused",
    "wide_pow_fused",
    "wide_spec",
]
