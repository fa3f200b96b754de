"""Device bitplane encoder/decoder with error collection.

A re-design of the reference BPEncoderRegisterBlock
(reference: include/mgard-x/MDR-X/BitplaneEncoder/BPEncoderRegisterBlock.hpp:15-470
— per-thread register bit-transpose of 32-element batches) and the
Max/Squared error collectors (reference: MDR-X/ErrorCollector/).

Layout: the level stream (n,) is viewed as (32, m) with m = n/32 — element
i sits at (i // m, i % m) — and ALL planes come out of ONE 32x32
bit-transpose butterfly over that view. Word j of a plane packs the 32
elements {j, m+j, 2m+j, ...} (strided), which makes the butterfly input a
free reshape instead of an (m, 32)+transpose relayout.

float32 streams quantize integer-exactly with NO f64 pass: the IEEE-754
bit pattern supplies (mantissa, exponent), and per-element integer shifts
produce the fixed-point magnitude, the rounding residue (exact, as
remi * 2^-kc), and the sign — so every device encodes bit-identical
planes. float64 streams
take the exact f64 path (error tables bit-match the decoder at rtol
1e-12). The f32 error tables carry a small relative inflation so they
remain true upper bounds (matching the reference's data-precision
collectors, MDR-X/ErrorCollector/ with T = data type).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..lossless.bfx import _bit_transpose32

LANES = 32

# Padding policy (a format property): streams of >= _PAD_TILE elements pad
# to a whole number of _PAD_TILE-element tiles, smaller levels pad to 32.
_PAD_TILE = LANES * 2048

# conservative inflation of the f32-path error tables: covers the f32
# residue representation error (2 ulp) and the staged f32 square-sums
# (<= 32-term + 512-term stages, ~3.3e-5 relative), so the tables stay
# true upper bounds for retrieval planning
_F32_SLACK = 1.0 + 1e-5
_F32_SLACK_SQ = 1.0 + 1e-4


def padded_len(n: int) -> int:
    """Encoded stream length for a level of n elements (padding policy)."""
    if n >= _PAD_TILE:
        return n + (-n) % _PAD_TILE
    return n + (-n) % LANES


def padded_words(n: int) -> int:
    """Words per plane for a level of n elements."""
    return padded_len(n) // LANES


def pad_stream(stream):
    """Zero-pad a flat level stream to the encoded length."""
    n = int(stream.shape[0])
    p = padded_len(n) - n
    if p:
        stream = jnp.concatenate([stream, jnp.zeros((p,), stream.dtype)])
    return stream


def _two_stage_sq_sum(d):
    """Sum of squares with bounded f32 accumulation error: f32 squares,
    128-term inner sums, f64 outer sum (inner relative error <= 128*2^-24,
    covered by _F32_SLACK_SQ)."""
    pad = (-d.shape[0]) % 128
    if pad:
        d = jnp.concatenate([d, jnp.zeros((pad,), d.dtype)])
    inner = jnp.sum((d * d).reshape(-1, 128), axis=1, dtype=jnp.float32)
    return jnp.sum(inner.astype(jnp.float64))


# ----------------------------------------------------------------------
# Integer-exact f32 fixed-point quantization
# ----------------------------------------------------------------------
def _int_quantize_f32(v, exp, frac_bits: int, lim: int):
    """p := |v| * 2^(frac_bits - exp), exactly. Returns
      mag  u32: round-half-away(p), clamped to lim
      remi i32: residue numerator, with p - mag == remi * 2^-kc
      kc   i32 in [0, 31]: residue scale (when the true scale is below
           2^-31 the residue MAGNITUDE is overestimated, bounded by 2^-7
           fixed-point units — elementwise >= the true residue, so error
           tables built from it stay upper bounds)
      sign i32: raw IEEE sign bit (negative zero counts negative).
    All integer ops on the IEEE-754 bit pattern — no f64, identical on
    every backend. Requires frac_bits <= 31 and exp >= ceil(log2(max|v|))
    so that the left-shift never exceeds frac_bits - 23 <= 8 bits."""
    bc = jax.lax.bitcast_convert_type
    bits = bc(v, jnp.int32)
    sign = jnp.bitwise_and(
        jax.lax.shift_right_logical(bits, jnp.int32(31)), 1
    )
    ebits = jnp.bitwise_and(
        jax.lax.shift_right_logical(bits, jnp.int32(23)), 0xFF
    )
    mant = jnp.bitwise_and(bits, 0x7FFFFF)
    issub = ebits == 0
    # everything stays in the i32 domain (bit patterns; shifts are
    # explicitly logical) with pure bitcasts at the signedness switches
    mant24 = jnp.where(issub, mant, jnp.bitwise_or(mant, 0x800000))
    e = jnp.where(issub, jnp.int32(-126), ebits - 127)
    sh = e - 23 + (frac_bits - exp)
    pos = sh >= 0
    shl = jnp.where(pos, sh, jnp.int32(0))
    kc = jnp.where(pos, jnp.int32(0), jnp.minimum(-sh, jnp.int32(31)))
    half = jax.lax.shift_right_logical(
        jax.lax.shift_left(jnp.int32(1), kc), jnp.int32(1)
    )
    f_unc = jnp.where(
        pos,
        jax.lax.shift_left(mant24, shl),
        jax.lax.shift_right_logical(mant24 + half, kc),
    )
    # clamp to lim in SIGNED space:
    # f_unc <= 2^(B-1) <= 2^31, so the only value outside i32 is exactly
    # 2^31, which shows up as a negative i32 — clamp it to lim too
    limi = jnp.int32(lim)
    magi = jnp.where(f_unc < 0, limi, jnp.minimum(f_unc, limi))
    remi = jax.lax.shift_left(mant24, shl) - jax.lax.shift_left(magi, kc)
    return bc(magi, jnp.uint32), remi, kc, sign


def _residue_f32(remi, kc):
    """remi * 2^-kc as f32 (2^-kc built from exponent bits; kc in [0,31])."""
    p2 = jax.lax.bitcast_convert_type((jnp.int32(127) - kc) << 23, jnp.float32)
    return remi.astype(jnp.float32) * p2


def _level_exp(amax64):
    """ceil(log2(amax)) as i32 (0 for amax == 0); scalar f64 math."""
    e = jnp.where(
        amax64 > 0, jnp.ceil(jnp.log2(jnp.maximum(amax64, 1e-300))), 0.0
    )
    return e.astype(jnp.int32)


def table_scale(exp: int, B: int, negabinary: bool = False) -> float:
    """Physical size of one fixed-point unit for a level (host float)."""
    return 2.0 ** (int(exp) - (B - 2 if negabinary else B - 1))


def scale_tables(err_max_u, err_sq_u, exp: int, B: int,
                 negabinary: bool = False):
    """Host-side conversion of unit-space error tables (what the device
    kernels return) to physical units. Done on HOST float64 because the
    physical values scale with amax^2 * n and can exceed the f32-pair
    range (~3.4e38) of devices that emulate float64 as an f32 pair."""
    s = np.float64(table_scale(exp, B, negabinary))
    return (np.asarray(err_max_u, np.float64) * s,
            np.asarray(err_sq_u, np.float64) * s * s)


def _sm_residual(fxi, r, B: int, b: int):
    """d_b in fixed-point units for the sign-magnitude code: the error of
    reconstructing from b leading magnitude planes (with midpoint
    correction) is |low_b - half_b + r| where low_b = fixed mod 2^(B-b)."""
    if b == 0:
        return fxi.astype(jnp.float32) + r
    low = jnp.bitwise_and(fxi, jnp.int32((1 << (B - b)) - 1))
    mag = fxi - low
    halfb = jnp.where(
        (b < B) & (mag > 0), jnp.int32(1 << max(B - b - 1, 0)), jnp.int32(0)
    )
    return (low - halfb).astype(jnp.float32) + r


def _sm_planes_from_zt(zt, B: int):
    """Reorder butterfly rows into [sign, MSB..LSB] plane order."""
    m = zt.shape[1]
    if B >= 32:
        # bit 31 carries the sign (magnitude tops out at 2^31 - 1, so the
        # true bit-31 magnitude plane is identically zero)
        return jnp.concatenate(
            [zt[31][None], jnp.zeros((1, m), jnp.uint32), zt[30::-1]], axis=0
        )
    return jnp.concatenate([zt[B][None], zt[B - 1 :: -1][:B]], axis=0)


@partial(jax.jit, static_argnums=(1,))
def encode_kernel(coeff, B: int):
    """Encode one level's flat coefficients into sign+magnitude bitplanes.

    coeff: (n,) float (n multiple of 32; pad with pad_stream).
    Returns (planes (B+1, n//32) uint32 [row 0 = signs, rows 1.. = MSB..LSB],
             exp int32 scalar,
             err_max (B+1,), err_sq (B+1,) float64 IN FIXED-POINT UNITS —
             callers apply scale_tables() on host; physical-unit tables can
             exceed the range of an emulated f32-pair float64)."""
    n = coeff.shape[0]
    m = n // LANES
    amax = jnp.max(jnp.abs(coeff))
    exp = _level_exp(amax.astype(jnp.float64))

    if coeff.dtype == jnp.float64:
        # exact f64 path
        v = coeff
        scale = jnp.exp2((B - 1) - exp.astype(jnp.float64))
        p = jnp.abs(v) * scale
        fixed = jnp.minimum(
            jnp.round(p), jnp.float64(2 ** (B - 1) - 1)
        ).astype(jnp.uint32)
        sign = (v < 0).astype(jnp.uint32)
        combined = fixed | (sign << jnp.uint32(min(B, 31)))
        zt = _bit_transpose32(combined.reshape(LANES, m))
        planes = _sm_planes_from_zt(zt, B)
        signf = jnp.where(sign == 1, -1.0, 1.0)
        err_max, err_sq = [], []
        for b in range(B + 1):
            if b == 0:
                rec = jnp.zeros_like(v)
            else:
                keep = jnp.uint32(0xFFFFFFFF) << jnp.uint32(B - b)
                mg = fixed & keep
                half = jnp.where(
                    (b < B) & (mg > 0),
                    jnp.uint32(1) << jnp.uint32(max(B - b - 1, 0)),
                    0,
                ).astype(jnp.float64)
                rec = signf * (mg.astype(jnp.float64) + half) / scale
            diff = (v - rec) * scale  # fixed-point units (exact 2^k scale)
            err_max.append(jnp.max(jnp.abs(diff)))
            err_sq.append(jnp.sum(diff * diff))
        return planes, exp, jnp.stack(err_max), jnp.stack(err_sq)

    # f32 integer-exact path
    mag, remi, kc, sign = _int_quantize_f32(
        coeff, exp, B - 1, 2 ** (B - 1) - 1
    )
    combined = jnp.bitwise_or(
        mag, sign.astype(jnp.uint32) << jnp.uint32(min(B, 31))
    )
    zt = _bit_transpose32(combined.reshape(LANES, m))
    fxi = jax.lax.bitcast_convert_type(mag, jnp.int32)
    r = _residue_f32(remi, kc)
    em_l, es_l = [], []
    for b in range(B + 1):
        d = _sm_residual(fxi, r, B, b)
        em_l.append(jnp.max(jnp.abs(d)).astype(jnp.float64))
        es_l.append(_two_stage_sq_sum(d))
    em, es = jnp.stack(em_l), jnp.stack(es_l)
    planes = _sm_planes_from_zt(zt, B)
    return planes, exp, em * _F32_SLACK, es * _F32_SLACK_SQ


def _pow2_scale_f32(x, e):
    """Exact ``x * 2**e`` for integer-valued f32 ``x`` (elements 0 or
    |x| >= 1) and a traced int32 scalar ``e`` — via IEEE exponent-field
    integer arithmetic.

    A plain ``x * exp2(e - k)`` (or any two-factor split of it) is unsafe
    here: XLA's algebraic simplifier merges scalar factors — observed in
    the optimized HLO on CPU, where the constant ``2^-(B-1)`` folds onto the
    runtime ``exp2(exp)`` — and the merged scale ``2^(exp-B+1)`` can be
    subnormal, which FTZ/DAZ execution (XLA CPU fast-math; GPU flush-to-
    zero modes)
    flushes to zero, silently zeroing every decoded value of a
    tiny-amplitude level (amax < 2^-118 at B=32). Adding ``e`` to the
    exponent field scales by a power of two exactly, with no fp scale
    factor for the compiler to create or the hardware to flush. Results
    whose true magnitude falls below the f32 normal range flush to ±0 (the
    same contract FTZ hardware gives a multiply)."""
    xi = jax.lax.bitcast_convert_type(x, jnp.int32)
    ef = jnp.right_shift(jnp.bitwise_and(xi, jnp.int32(0x7F800000)), 23)
    new_e = ef + e
    out = jax.lax.bitcast_convert_type(
        xi + jnp.left_shift(e, 23), jnp.float32
    )
    # ef==0 covers ±0 inputs; new_e<=0 underflows (flush to 0); new_e>=255
    # cannot occur for in-contract inputs (|x| <= 2^(B-1), result <= amax*2)
    # but clamp to ±inf rather than wrap into garbage bits
    signb = jnp.bitwise_and(xi, jnp.int32(np.int32(-(2**31))))
    inf = jax.lax.bitcast_convert_type(
        jnp.bitwise_or(signb, jnp.int32(0x7F800000)), jnp.float32
    )
    out = jnp.where(new_e >= 255, inf, out)
    return jnp.where((ef == 0) | (new_e <= 0), jnp.float32(0.0), out)


@partial(jax.jit, static_argnums=(2, 3, 4))
def decode_kernel(planes, exp, B: int, b: int, out_dtype=jnp.float64):
    """Reconstruct coefficients from the sign plane + the b leading
    magnitude planes. planes: (>= 1+b, m) uint32. Returns (m*32,) out_dtype
    (f32 output computes in f32 — reconstruction precision beyond the data
    dtype is unobservable, and f64 is slow on most accelerators)."""
    m = planes.shape[1]
    ft = jnp.dtype(out_dtype)
    sbit = min(B, 31)
    zero = jnp.zeros((m,), jnp.uint32)
    rows = {sbit: planes[0]}
    for i in range(b):
        tb = B - 1 - i
        if 0 <= tb <= 31 and tb != sbit:
            rows[tb] = planes[1 + i]
    zt = jnp.stack([rows.get(j, zero) for j in range(32)])
    cb = _bit_transpose32(zt)
    mag = jnp.bitwise_and(cb, jnp.uint32((1 << sbit) - 1))
    sign = jnp.bitwise_and(
        jax.lax.shift_right_logical(cb, jnp.uint32(sbit)), jnp.uint32(1)
    )
    half = jnp.where(
        (mag > 0) & (b < B),
        jnp.uint32(1) << jnp.uint32(max(B - b - 1, 0)),
        jnp.uint32(0),
    )
    signf = jnp.where(sign == 1, ft.type(-1.0), ft.type(1.0))
    fixed = signf * (mag + half).astype(ft)
    if ft == jnp.dtype(jnp.float32):
        vals = _pow2_scale_f32(fixed, exp.astype(jnp.int32) - (B - 1))
    else:
        vals = fixed * jnp.exp2(exp.astype(ft) - (B - 1))
    return vals.reshape(m * LANES)


# ----------------------------------------------------------------------
# NegaBinary encoding (reference: NegaBinaryBPEncoder, MDR/BitplaneEncoder/
# and the EncodeNegaBinary path of BPEncoderRegisterBlock.hpp:183): signed
# fixed-point values are mapped to base(-2) digits, removing the separate
# sign plane; truncating trailing planes still yields a signed value.
# ----------------------------------------------------------------------
def _nb_mask(B: int) -> int:
    """0b1010...10 over B bits (weights of the odd, negative, positions)."""
    m = 0
    for j in range(1, B, 2):
        m |= 1 << j
    return m


@partial(jax.jit, static_argnums=(1,))
def encode_kernel_negabinary(coeff, B: int):
    """NegaBinary variant of encode_kernel.

    Returns (planes (B, n//32) uint32 [rows = MSB..LSB, no sign plane],
    exp, err_max (B+1,), err_sq (B+1,)). The fixed-point scale uses B-2
    fraction bits so both signs fit the B-bit negabinary range
    [-(2/3)2^B, (1/3)2^B).

    Same dtype split as encode_kernel: f64 input (or B > 30, where the
    digit arithmetic needs more than i32) -> exact f64 tables; f32 input
    -> the integer-exact path."""
    n = coeff.shape[0]
    m = n // LANES
    exact = coeff.dtype == jnp.float64 or B > 30
    amax = jnp.max(jnp.abs(coeff))
    exp = _level_exp(amax.astype(jnp.float64))
    M = _nb_mask(B)
    lim = 2 ** (B - 2) - 1

    if exact:
        v = coeff.astype(jnp.float64)
        scale = jnp.exp2((B - 2) - exp.astype(jnp.float64))
        p = v * scale
        fixed = jnp.clip(jnp.round(p), -float(lim), float(lim)).astype(
            jnp.int64
        )
        u = ((fixed + M) ^ M).astype(jnp.uint32)  # B-bit negabinary digits
        zt = _bit_transpose32(u.reshape(LANES, m))
        planes = zt[B - 1 :: -1][:B]  # (B, m): MSB first
        err_max, err_sq = [], []
        for b in range(B + 1):
            if b == 0:
                rec = jnp.zeros_like(v)
            else:
                keep = jnp.uint32(((1 << B) - 1) & ~((1 << (B - b)) - 1))
                ut = u & keep
                xt = (ut.astype(jnp.int64) ^ M) - M
                rec = xt.astype(jnp.float64) / scale
            diff = (v - rec) * scale  # fixed-point units (exact 2^k scale)
            err_max.append(jnp.max(jnp.abs(diff)))
            err_sq.append(jnp.sum(diff * diff))
        return planes, exp, jnp.stack(err_max), jnp.stack(err_sq)

    # f32 integer-exact path (B <= 30: digits and masks fit i32)
    magu, remi, kc, sign = _int_quantize_f32(coeff, exp, B - 2, lim)
    signi = (1 - 2 * sign).astype(jnp.int32)
    fixed = signi * jax.lax.bitcast_convert_type(magu, jnp.int32)
    r = _residue_f32(remi, kc) * signi.astype(jnp.float32)
    u = jnp.bitwise_xor(fixed + jnp.int32(M), jnp.int32(M)).astype(jnp.uint32)
    zt = _bit_transpose32(u.reshape(LANES, m))
    planes = zt[B - 1 :: -1][:B]
    Mi = jnp.int32(M)
    err_max, err_sq = [], []
    for b in range(B + 1):
        if b == 0:
            d = fixed.astype(jnp.float32) + r
        else:
            keep = jnp.int32(((1 << B) - 1) & ~((1 << (B - b)) - 1))
            ut = jnp.bitwise_and(
                jax.lax.bitcast_convert_type(u, jnp.int32), keep
            )
            xt = jnp.bitwise_xor(ut, Mi) - Mi
            d = (fixed - xt).astype(jnp.float32) + r
        err_max.append(jnp.max(jnp.abs(d)).astype(jnp.float64) * _F32_SLACK)
        err_sq.append(_two_stage_sq_sum(d) * _F32_SLACK_SQ)
    return planes, exp, jnp.stack(err_max), jnp.stack(err_sq)


@partial(jax.jit, static_argnums=(2, 3, 4))
def decode_kernel_negabinary(planes, exp, B: int, b: int, out_dtype=jnp.float64):
    """Reconstruct from the b leading negabinary planes.
    planes: (>= b, m) uint32. Returns (m*32,) out_dtype."""
    m = planes.shape[1]
    ft = jnp.dtype(out_dtype)
    zero = jnp.zeros((m,), jnp.uint32)
    rows = {}
    for i in range(b):
        tb = B - 1 - i
        if 0 <= tb <= 31:
            rows[tb] = planes[i]
    zt = jnp.stack([rows.get(j, zero) for j in range(32)])
    cb = _bit_transpose32(zt)
    M = _nb_mask(B)
    x = (cb.astype(jnp.int64) ^ M) - M
    fixed = x.astype(ft)
    if ft == jnp.dtype(jnp.float32):
        vals = _pow2_scale_f32(fixed, exp.astype(jnp.int32) - (B - 2))
    else:
        vals = fixed * jnp.exp2(exp.astype(ft) - (B - 2))
    return vals.reshape(m * LANES)


def encode_level(coeff_flat, B: int):
    """Host wrapper: pad to the encoded length, encode, scale tables."""
    n = int(coeff_flat.shape[0])
    coeff_flat = pad_stream(jnp.asarray(coeff_flat))
    planes, exp, em_u, es_u = encode_kernel(coeff_flat, B)
    em, es = scale_tables(em_u, es_u, int(exp), B)
    return planes, int(exp), em, es, n


def decode_level(planes, exp: int, B: int, b: int, n: int):
    """Host wrapper: decode with b magnitude planes, trim padding."""
    vals = decode_kernel(jnp.asarray(planes), jnp.asarray(exp, jnp.int32), B, b)
    return vals[:n]
