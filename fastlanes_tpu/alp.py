"""ALP: Adaptive Lossless floating-Point compression on the FastLanes
machinery (Afroozeh, Kuffo & Boncz, "ALP: Adaptive Lossless floating-Point
Compression", SIGMOD 2023 — the codec family the FastLanes VLDB'23 paper
builds toward; NOT part of the Rust reference crate, which is integer-only:
reference src/ has no float code. This is beyond-parity surface).

Scheme (self-consistent spec, chosen for device reproducibility):

  encode:  ints = round(v * 10^e * 10^-f)            (host, float64 math)
  decode:  v'   = float(ints) / 10^(e-f)             (value dtype, ONE
                                                      correctly rounded
                                                      IEEE division)
  exceptions: every position where decode(encode(v)) != v bitwise (NaN,
  inf, overflow, precision loss) stores the original value verbatim and is
  patched after decode; its slot in the int stream holds a filler so it
  never widens the packed width.

Why DIVIDE instead of one multiply by 10^(f-e): 10^(e-f) is exactly
representable in the value dtype over the whole search range
(10^d = 2^d * 5^d and 5^10 < 2^24 for f32, 5^18 < 2^53 for f64), so for
|ints| inside the exact-conversion range the IEEE division yields the
correctly rounded quotient — identical to how the original decimal value
rounded into the dtype. A single multiply by the INEXACT factor 10^(f-e)
loses that (measured ~27% exceptions on 2-decimal f32 data vs ~0 with the
division form). One division (not multiply-then-divide) keeps the device
emulation to a single rounding.

The integer stream is FFoR'd (shifted by its min) and bit-packed with the
existing integer codecs, so ALP decode on device = unfor-style unshift ->
convert -> one multiply -> exception scatter. IEEE-754 multiply and
int->float conversion round identically on numpy and XLA, so the decode
spec is bit-exact across hosts and chips — and the encoder's roundtrip
check makes correctness independent of that anyway: any value the spec
cannot reproduce is an exception by construction.

float32 columns: |i * 10^f| bounded below 2^24 (exact in int32 AND f32),
payload u32. The device decode computes the IEEE quotient in the INTEGER
domain — see _div_pow10_f32_device — so it is bit-exact with the host spec
whatever a backend's float divide rounds to.
float64 columns: ints bounded to +-2^52, payload u64 (limb pairs); the
device decode emulates the spec's single correctly-rounded f64 division in
the integer limb domain (_div_pow10_f64_limbs) — x64-FREE; without x64
the result is the (..., 2) uint32 f64 bit image.
"""

from __future__ import annotations

import numpy as np

# exponent search space (the ALP paper's ranges): 10^e exactly representable
# in the float64 encode domain
_MAX_E = {4: 10, 8: 18}
# f64 |ints| bound: exact int64->f64 conversion domain (f32 uses the
# tighter |i * 10^f| < 2^24 bound computed in _ok_mask)
_INT_BOUND = {8: 2 ** 52}


def _pow10(k: int, np_float) -> np.floating:
    """10^k in the value dtype — exact over the search range (see module
    docstring)."""
    return np_float(np.float64(10.0) ** k)


def _encode_ints(values64: np.ndarray, e: int, f: int) -> np.ndarray:
    """round(v * 10^e / 10^f) in float64, as int64 (non-finite/overflow
    positions produce garbage here and are filtered by _ok_mask)."""
    with np.errstate(over="ignore", invalid="ignore"):
        scaled = values64 * (np.float64(10.0) ** e) * (np.float64(10.0) ** -f)
    scaled = np.where(np.isfinite(scaled), scaled, 0.0)
    scaled = np.clip(scaled, -(2.0 ** 62), 2.0 ** 62)
    return np.round(scaled).astype(np.int64)


def _decode_np(ints: np.ndarray, e: int, f: int, np_float) -> np.ndarray:
    """ONE correctly rounded IEEE division: v = i / 10^(e-f).

    Spec note (round 3): this replaced the older multiply-then-divide chain
    (i * 10^f, then / 10^e). For every in-range f32 value the two are
    bit-identical (all intermediates exact, single rounding either way);
    for f64 the single-division form avoids a second rounding when
    i * 10^f exceeds 2^53, and — decisively — it is emulable bit-exactly
    in the integer limb domain (_div_pow10_f64_limbs): the device
    needs only ONE rounding to reproduce, with exact operands
    (|i| <= 2^52, 10^d = 2^d * 5^d exact in f64 for d <= 18)."""
    return (ints.astype(np_float) / _pow10(e - f, np_float)).astype(np_float)


def _ok_mask(values: np.ndarray, ints: np.ndarray, e: int, f: int) -> np.ndarray:
    """Positions the spec reproduces exactly AND whose int fits the device
    domain. NaN/inf fail the equality (NaN != NaN) and become exceptions.

    f32 in-range bound: |i * 10^f| < 2^24, so the scaled int is exact in
    both int32 and f32 and the device's integer-domain division
    (_div_pow10_f32_device) is bit-identical to the host's IEEE f32 divide.
    f64 bound: |i| <= 2^52 (exact int64->f64 conversion; host and device
    then run the identical f64 op sequence)."""
    np_float = values.dtype.type
    if values.dtype.itemsize == 4:
        bound = ((1 << 24) - 1) // (10 ** f)
    else:
        bound = _INT_BOUND[8]
    dec = _decode_np(ints, e, f, np_float)
    # bitwise equality: value equality AND matching sign bit (-0.0 == +0.0
    # numerically but must round-trip its sign)
    ok = (dec == values) & (np.signbit(dec) == np.signbit(values))
    return ok & (ints >= -bound) & (ints <= bound)


def choose_ef(sample: np.ndarray) -> tuple[int, int]:
    """Pick (e, f) minimizing estimated bits/value on a sample: packed width
    of the FFoR'd ints plus the exception overhead (position + raw value).
    Deterministic: ties break toward smaller e, then smaller f."""
    itemsize = sample.dtype.itemsize
    vals64 = sample.astype(np.float64)
    best = (float("inf"), 0, 0)
    for e in range(_MAX_E[itemsize] + 1):
        for f in range(e + 1):
            ints = _encode_ints(vals64, e, f)
            ok = _ok_mask(sample, ints, e, f)
            n_exc = int(sample.size - np.count_nonzero(ok))
            if n_exc == sample.size:
                continue
            good = ints[ok]
            spread = int(good.max() - good.min()) if good.size else 0
            width = spread.bit_length()
            bits = width + n_exc / sample.size * (itemsize * 8 + 32)
            if bits < best[0] - 1e-9:
                best = (bits, e, f)
    return best[1], best[2]


def encode_np(values: np.ndarray, e=None, f=None) -> dict:
    """Encode a float32/float64 array. Returns
    {e, f, reference, width, ints, exc_pos, exc_val}: `ints` is the FFoR'd
    (min-shifted) non-negative unsigned stream ready for bit-packing
    (uint32 for f32, uint64 for f64); exceptions carry original values."""
    if values.dtype not in (np.float32, np.float64):
        raise ValueError(f"ALP encodes float32/float64, got {values.dtype}")
    if e is None or f is None:
        flat = values.reshape(-1)
        sample = np.ascontiguousarray(flat[:: max(1, flat.size // 2048)][:2048])
        e, f = choose_ef(sample)
    ints = _encode_ints(values.astype(np.float64), e, f)
    ok = _ok_mask(values, ints, e, f)
    exc_pos = np.flatnonzero(~ok).astype(np.uint32)
    exc_val = values.reshape(-1)[exc_pos]
    good = ints.reshape(-1)[ok.reshape(-1)]
    fill = np.int64(good[0]) if good.size else np.int64(0)
    ints = ints.reshape(-1).copy()
    ints[exc_pos] = fill
    ints = ints.reshape(values.shape)
    ref = int(ints.min()) if ints.size else 0
    shifted = ints - np.int64(ref)
    width = int(shifted.max()).bit_length() if shifted.size else 0
    u_dt = np.uint32 if values.dtype == np.float32 else np.uint64
    return {
        "e": int(e), "f": int(f), "reference": ref, "width": width,
        "ints": shifted.astype(u_dt), "exc_pos": exc_pos, "exc_val": exc_val,
    }


def decode_np(shifted: np.ndarray, e: int, f: int, reference: int,
              np_float, exc_pos=None, exc_val=None) -> np.ndarray:
    """Inverse of encode_np: unshift, multiply by FACTOR in the value dtype,
    patch exceptions."""
    ints = shifted.astype(np.int64) + np.int64(reference)
    out = np.ascontiguousarray(_decode_np(ints, e, f, np_float))
    if exc_pos is not None and len(exc_pos):
        flat = out.reshape(-1)
        flat[np.asarray(exc_pos, np.int64)] = exc_val
        out = flat.reshape(out.shape)
    return out


def _div_pow10_f32_device(x_int, d: int):
    """Correctly-rounded f32 quotient x / 10^d for exact int32 x
    (|x| < 2^24), WITHOUT floating-point division — the IEEE division the
    wire spec demands is computed exactly in the integer domain, so no
    backend's divide rounding can change the decoded bits:

      x/10^d = (x/5^d) * 2^-d   (power-of-2 scaling commutes with RN)

    then floor(a<<k / 5^d) by chunked long division (7-bit steps keep every
    intermediate inside int32), producing a 25-bit quotient = 24-bit
    mantissa + round bit, remainder = sticky, round-to-nearest-even, and an
    exact jnp.ldexp scale. ~30 int32 vector ops/element — still
    HBM-bound at decode batch sizes."""
    import jax
    import jax.numpy as jnp

    if d == 0:
        return x_int.astype(jnp.float32)
    F = 5 ** d
    K = F.bit_length()  # 2^K/F in (1, 2]; quotient lands in [2^23, 2^25)

    x_int = x_int.astype(jnp.int32)
    neg = x_int < 0
    a = jnp.where(neg, -x_int, x_int)
    zero = a == 0
    a_safe = jnp.where(zero, jnp.int32(1), a)
    # normalize |x| to [2^23, 2^24): za in [0, 23]
    nbits = jnp.int32(32) - jax.lax.clz(a_safe)
    za = jnp.int32(24) - nbits
    an = a_safe << za
    # long division: q = floor(an * 2^K / F), r = remainder — K extra bits
    # fed in chunks of <= 7 so r << s stays < F * 2^7 <= 2^31
    q = an // jnp.int32(F)
    r = an - q * jnp.int32(F)
    rem_bits = K
    while rem_bits > 0:
        s = min(7, rem_bits)
        r = r << s
        step = r // jnp.int32(F)
        q = (q << s) + step
        r = r - step * jnp.int32(F)
        rem_bits -= s
    # q in [2^23 * 2^K/F, 2^24 * 2^K/F) subset [2^23, 2^25): widen 24-bit
    # cases by one more quotient bit so q uniformly holds 25 bits
    need = q < jnp.int32(1 << 24)
    r2 = r << 1
    bit = (r2 >= jnp.int32(F)).astype(jnp.int32)
    q = jnp.where(need, (q << 1) + bit, q)
    r = jnp.where(need, r2 - bit * jnp.int32(F), r)
    kadj = need.astype(jnp.int32)
    # round to nearest, ties to even
    round_bit = q & 1
    q_hi = q >> 1  # 24-bit mantissa in [2^23, 2^24)
    sticky = (r != 0).astype(jnp.int32)
    q_hi = q_hi + (round_bit & (sticky | (q_hi & 1)))
    # value = q * 2^-(za + K + kadj) * 2^-d, q = 2*q_hi (pre-round)
    exp = -(za + jnp.int32(K) + kadj) + jnp.int32(1 - d)
    out = jnp.ldexp(q_hi.astype(jnp.float32), exp)
    out = jnp.where(zero, jnp.float32(0.0), out)
    return jnp.where(neg, -out, out).astype(jnp.float32)


def _div_pow10_f64_limbs(lo, hi, d: int):
    """Correctly-rounded float64 quotient i / 10^d for an int64 i given as
    (lo, hi) uint32 limbs (two's complement), |i| <= 2^52, 0 <= d <= 18 —
    WITHOUT int64/float64 arithmetic. Returns the (lo, hi) uint32 limb image
    of the IEEE f64 result: bit-exact with numpy's
    ``np.float64(i) / np.float64(10.0**d)`` (validated by an exhaustive
    random+adversarial sweep in tests/test_alp_f64_device.py).

    Method (the f64 generalization of _div_pow10_f32_device, two-limb):

      i/10^d = (|i| / 5^d) * 2^-d * sign     (2^d scaling commutes with RN)

    normalize |i| to M in [2^52, 2^53) (za static-free via shl_dyn), then
    long-divide M*2^K by F = 5^d (K = F.bit_length()) in 7-bit chunks.
    Every chunk's quotient digit is estimated with an f32 reciprocal
    multiply (|error| < 1 since digit <= 127 and the f32 relative error is
    ~2^-22) and corrected exactly against the two-limb remainder; digits
    accumulate into a two-limb quotient. A final conditional widen makes
    the quotient uniformly 54 bits; round-to-nearest-even with the sticky
    remainder gives the 53-bit mantissa, and the exponent/sign/mantissa
    pack into f64 bits directly. All ops are uint32 vector ops — identical
    results on every jax backend."""
    import jax
    import jax.numpy as jnp

    u32 = jnp.uint32
    lo = lo.astype(u32)
    hi = hi.astype(u32)
    neg = (hi >> u32(31)) == u32(1)
    # |i|: two's-complement negate where negative
    alo = jnp.where(neg, u32(0) - lo, lo)
    ahi = jnp.where(neg, ~hi + (lo == u32(0)).astype(u32), hi)
    zero = (alo == u32(0)) & (ahi == u32(0))
    alo_safe = jnp.where(zero, u32(1), alo)
    # bit length n of |i| in [1, 53]
    n = jnp.where(ahi != u32(0),
                  jnp.int32(64) - jax.lax.clz(ahi).astype(jnp.int32),
                  jnp.int32(32) - jax.lax.clz(alo_safe).astype(jnp.int32))
    za = jnp.int32(53) - n                     # in [0, 52]
    mlo, mhi = eng_shl_dyn((alo_safe, ahi), za)  # M in [2^52, 2^53)

    if d == 0:
        # exact: |i| <= 2^52 < 2^53, the mantissa IS M
        q_lo, q_hi = mlo, mhi
        exp_unb = n - jnp.int32(1)
    else:
        F = 5 ** d                             # < 2^42
        K = F.bit_length()
        f0, f1 = F & 0xFFFFFFFF, F >> 32
        inv_f = np.float32(1.0 / F)
        n_bits = 53 + K                        # dividend D = M << K
        # 7-bit chunks, first chunk sized so the total is exactly n_bits
        sizes = []
        rem = n_bits
        first = n_bits % 7 or 7
        sizes.append(first)
        rem -= first
        while rem:
            sizes.append(7)
            rem -= 7
        # D's bit j (0 = LSB) for j in [K, 53+K) is M bit j-K; below K is 0.
        consumed = 0
        r0 = jnp.zeros_like(mlo)
        r1 = jnp.zeros_like(mlo)
        q_lo = jnp.zeros_like(mlo)
        q_hi = jnp.zeros_like(mlo)
        two32 = np.float32(2.0) ** 32
        for s in sizes:
            consumed += s
            # next s bits of D, MSB-first: bits [n_bits-consumed, +s)
            base = n_bits - consumed           # static
            chunk = _extract_bits_2limb(mlo, mhi, base - K, s)
            # r = (r << s) | chunk  (r < F so r<<s fits 49 bits)
            r1 = (r1 << u32(s)) | (r0 >> u32(32 - s))
            r0 = (r0 << u32(s)) | chunk
            # digit estimate: f32 reciprocal multiply, exact correction
            rf = r1.astype(jnp.float32) * two32 + r0.astype(jnp.float32)
            step = (rf * inv_f).astype(jnp.int32)
            step = jnp.clip(step, 0, (1 << s) - 1).astype(u32)
            p0, p1 = _mul_small_2limb(step, f0, f1)
            b0, b1, neg_r = _sub_2limb(r0, r1, p0, p1)
            # step one too high: add F back
            a0, a1, _ = _add_2limb(b0, b1, u32(f0), u32(f1))
            r0 = jnp.where(neg_r, a0, b0)
            r1 = jnp.where(neg_r, a1, b1)
            step = step - neg_r.astype(u32)
            # step one too low: subtract F once more
            ge = _ge_2limb(r0, r1, u32(f0), u32(f1))
            c0, c1, _ = _sub_2limb(r0, r1, u32(f0), u32(f1))
            r0 = jnp.where(ge, c0, r0)
            r1 = jnp.where(ge, c1, r1)
            step = step + ge.astype(u32)
            q_hi = (q_hi << u32(s)) | (q_lo >> u32(32 - s))
            q_lo = (q_lo << u32(s)) | step
        # Q = floor(M*2^K/F) in [2^52, 2^54); widen the 53-bit cases so Q
        # uniformly holds 54 bits (mantissa + round bit)
        need = q_hi < u32(1 << 21)             # Q < 2^53
        r1w = (r1 << u32(1)) | (r0 >> u32(31))
        r0w = r0 << u32(1)
        bit = _ge_2limb(r0w, r1w, u32(f0), u32(f1))
        s0, s1, _ = _sub_2limb(r0w, r1w, u32(f0), u32(f1))
        q_hi_w = (q_hi << u32(1)) | (q_lo >> u32(31))
        q_lo_w = (q_lo << u32(1)) | bit.astype(u32)
        q_lo = jnp.where(need, q_lo_w, q_lo)
        q_hi = jnp.where(need, q_hi_w, q_hi)
        r0 = jnp.where(need, jnp.where(bit, s0, r0w), r0)
        r1 = jnp.where(need, jnp.where(bit, s1, r1w), r1)
        kadj = need.astype(jnp.int32)
        # round to nearest, ties to even
        round_bit = q_lo & u32(1)
        m_lo = (q_lo >> u32(1)) | (q_hi << u32(31))
        m_hi = q_hi >> u32(1)                  # 53-bit mantissa in [2^52, 2^53)
        sticky = ((r0 | r1) != u32(0)).astype(u32)
        inc = round_bit & (sticky | (m_lo & u32(1)))
        m_lo = m_lo + inc
        m_hi = m_hi + (m_lo == u32(0)).astype(u32) * (inc != u32(0)).astype(u32)
        # mantissa overflow 2^53 -> 2^52, exponent +1
        ovf = m_hi == u32(1 << 21)
        m_hi = jnp.where(ovf, u32(1 << 20), m_hi)
        exp_unb = (jnp.int32(53) - jnp.int32(K) - kadj - za - jnp.int32(d)
                   + ovf.astype(jnp.int32))
        q_lo, q_hi = m_lo, m_hi
    expfield = (exp_unb + jnp.int32(1023)).astype(u32)
    out_hi = (neg.astype(u32) << u32(31)) | (expfield << u32(20)) | (q_hi & u32(0xFFFFF))
    out_lo = q_lo
    out_hi = jnp.where(zero, u32(0), out_hi)
    out_lo = jnp.where(zero, u32(0), out_lo)
    return out_lo, out_hi


def eng_shl_dyn(vec, k):
    """shl by traced k on a (lo, hi) uint32 limb pair (thin alias over the
    ops engine to keep alp.py import-light at module load)."""
    from .ops import _engine as eng

    return eng.shl_dyn(vec, k, "u64")


def _extract_bits_2limb(mlo, mhi, base: int, s: int):
    """Bits [base, base+s) of the two-limb value (static base; negative
    base positions read as zero bits below the LSB)."""
    import jax.numpy as jnp

    u32 = jnp.uint32
    if base <= -s:
        return jnp.zeros_like(mlo)
    shift_back = 0
    if base < 0:
        shift_back = -base
        s = s + base
        base = 0
    if base >= 32:
        out = (mhi >> u32(base - 32)) & u32((1 << s) - 1)
    elif base + s <= 32:
        out = (mlo >> u32(base)) & u32((1 << s) - 1)
    else:
        lo_bits = 32 - base
        out = ((mlo >> u32(base)) | (mhi << u32(lo_bits))) & u32((1 << s) - 1)
    return out << u32(shift_back) if shift_back else out


def _mul_small_2limb(step, f0: int, f1: int):
    """step * F for vector step < 2^8 and constant F = f1*2^32 + f0 < 2^42;
    exact two-limb product (fits 50 bits)."""
    import jax.numpy as jnp

    u32 = jnp.uint32
    p_low = step * u32(f0 & 0xFFFF)
    p_mid = step * u32(f0 >> 16)
    lo = p_low + ((p_mid & u32(0xFFFF)) << u32(16))
    carry = (lo < p_low).astype(u32)
    hi = (p_mid >> u32(16)) + step * u32(f1) + carry
    return lo, hi


def _add_2limb(a0, a1, b0, b1):
    import jax.numpy as jnp

    lo = a0 + b0
    carry = (lo < a0).astype(jnp.uint32)
    return lo, a1 + b1 + carry, None


def _sub_2limb(a0, a1, b0, b1):
    """a - b over two limbs; third result: borrow-out (a < b)."""
    import jax.numpy as jnp

    lo = a0 - b0
    borrow = (a0 < b0).astype(jnp.uint32)
    hi = a1 - b1 - borrow
    neg = (a1 < b1) | ((a1 == b1) & (a0 < b0))
    return lo, hi, neg


def _ge_2limb(a0, a1, b0, b1):
    return (a1 > b1) | ((a1 == b1) & (a0 >= b0))


def decode_device(shifted, e: int, f: int, reference: int, np_float,
                  exc_pos=None, exc_val=None):
    """Device twin of decode_np (jnp): unshift -> convert -> scale ->
    scatter-patch, bit-exact with the host spec.

    f32 payloads: the multiply by 10^f stays in the exact-int domain and
    the divide by 10^e runs through _div_pow10_f32_device (exact integer
    division; the encoder's in-range bound keeps |i * 10^f| < 2^24 so both
    steps are exact).

    f64 payloads: x64-FREE — `shifted` may be the (..., 2) uint32 limb
    image (the x64-free form); the single correctly-rounded division of the
    wire spec runs in the integer limb domain (_div_pow10_f64_limbs) and
    the result comes back as float64 when jax x64 is enabled, else as the
    (..., 2) uint32 limb image of the f64 bits (bitcastable by any x64
    consumer). int64 `shifted` (legacy CPU form) is also accepted."""
    import jax
    import jax.numpy as jnp

    if np_float == np.float64:
        from .ops import _engine as eng

        arr = jnp.asarray(shifted)
        if arr.dtype == jnp.uint32:  # (..., 2) limb image
            lo, hi = arr[..., 0], arr[..., 1]
            shape = arr.shape[:-1]
        else:  # int64/uint64 (x64 on)
            bits = jax.lax.bitcast_convert_type(
                arr.astype(jnp.uint64), jnp.uint32)
            lo, hi = bits[..., 0], bits[..., 1]
            shape = arr.shape
        rlo = np.uint32(reference & 0xFFFFFFFF)
        rhi = np.uint32((reference >> 32) & 0xFFFFFFFF)
        lo, hi = lo.reshape(-1), hi.reshape(-1)
        ilo, ihi = eng.add((lo, hi), (jnp.full_like(lo, rlo),
                                      jnp.full_like(hi, rhi)), "u64")
        olo, ohi = _div_pow10_f64_limbs(ilo, ihi, e - f)
        if exc_pos is not None and len(exc_pos):
            elimb = (np.asarray(exc_val, np.float64)
                     .view(np.uint32).reshape(-1, 2))
            pos = jnp.asarray(np.asarray(exc_pos, np.int32))
            olo = olo.at[pos].set(jnp.asarray(elimb[:, 0]))
            ohi = ohi.at[pos].set(jnp.asarray(elimb[:, 1]))
        out = jnp.stack([olo, ohi], axis=-1).reshape(*shape, 2)
        if jax.config.read("jax_enable_x64"):
            return jax.lax.bitcast_convert_type(out, jnp.float64)
        return out
    ints = shifted.astype(jnp.int32) + jnp.int32(reference)
    x = ints * jnp.int32(10 ** f)  # exact: in-range values are < 2^24
    out = _div_pow10_f32_device(x, e)
    if exc_pos is not None and len(exc_pos):
        flat = out.reshape(-1)
        flat = flat.at[jnp.asarray(np.asarray(exc_pos, np.int64))].set(
            jnp.asarray(exc_val))
        out = flat.reshape(out.shape)
    return out


# ---------------------------------------------------------------------------
# ALP_RD: the "real doubles" fallback (ALP paper §4.3) for floats that are
# NOT decimal-like (the plain ALP scheme would emit ~100% exceptions).
# Each value's bit pattern splits at a cut point into a LEFT part (sign +
# exponent + top mantissa bits — few distinct values on real data, so
# dictionary-coded at ceil(log2(dict)) bits) and a RIGHT part (low mantissa
# bits, near-entropy, stored bit-packed verbatim). Decode is pure integer
# ops: value_bits = (dict[left_idx] << right_bits) | right. Always
# lossless; compression comes from the left dictionary.

_RD_MAX_DICT = 8  # left dictionary entries (3-bit indices, per the paper)


def rd_choose_cut(bits: np.ndarray, total_bits: int) -> int:
    """Pick right-part width minimizing estimated bits/value: right_bits +
    index bits + exception overhead. Candidate cuts keep the left part
    <= 32 bits (the dictionary-entry domain; lefts > 16 bits cost 32-bit
    exception storage on the wire, priced in below). For f64 the floor
    right_bits >= 32 also keeps the device decode's single cross-limb
    shift valid (rd_decode_device)."""
    flat = bits.reshape(-1)
    sample = flat[:: max(1, flat.size // 2048)][:2048]
    best = (float("inf"), total_bits - 1)
    for right_bits in range(max(total_bits - 32, 1), total_bits):
        left_bits = total_bits - right_bits
        lefts, counts = np.unique(sample >> right_bits, return_counts=True)
        order = np.argsort(counts)[::-1]
        in_dict = counts[order[:_RD_MAX_DICT]].sum()
        exc_rate = 1.0 - in_dict / sample.size
        idx_bits = max(1, int(np.ceil(np.log2(min(len(lefts), _RD_MAX_DICT) + 1e-9)))
                       ) if len(lefts) > 1 else 1
        exc_store = 16 if left_bits <= 16 else 32
        cost = right_bits + idx_bits + exc_rate * (exc_store + 32)
        if cost < best[0] - 1e-9:
            best = (cost, right_bits)
    return best[1]


def rd_encode_np(values: np.ndarray) -> dict:
    """Encode float32/float64 via the left/right split. Returns
    {right_bits, dict (uint16/uint32 lefts), left_idx (uint16), rights
    (uint of value size), exc_pos (uint32), exc_left (uint32)} — exceptions
    are positions whose LEFT part is outside the dictionary; their left
    value is stored verbatim and their left_idx slot is 0."""
    if values.dtype not in (np.float32, np.float64):
        raise ValueError(f"ALP_RD encodes float32/float64, got {values.dtype}")
    t = values.dtype.itemsize * 8
    u_dt = np.uint32 if t == 32 else np.uint64
    bits = values.view(u_dt)
    right_bits = rd_choose_cut(bits, t)
    lefts = (bits >> u_dt(right_bits)).reshape(-1)
    rights = bits & u_dt((1 << right_bits) - 1)
    uniq, counts = np.unique(lefts, return_counts=True)
    order = np.argsort(counts)[::-1][:_RD_MAX_DICT]
    dictionary = np.sort(uniq[order])  # deterministic wire order
    pos = np.searchsorted(dictionary, lefts)
    pos = np.clip(pos, 0, len(dictionary) - 1)
    hit = dictionary[pos] == lefts
    exc_pos = np.flatnonzero(~hit).astype(np.uint32)
    exc_left = lefts[~hit].astype(np.uint32)  # left <= 32 bits
    left_idx = np.where(hit, pos, 0).astype(np.uint16)
    return {
        "right_bits": int(right_bits),
        "dict": dictionary.astype(np.uint32),
        "left_idx": left_idx.reshape(values.shape),
        "rights": rights,
        "exc_pos": exc_pos,
        "exc_left": exc_left,
    }


def rd_decode_np(left_idx, rights, dictionary, right_bits: int, np_float,
                 exc_pos=None, exc_left=None) -> np.ndarray:
    t = np.dtype(np_float).itemsize * 8
    u_dt = np.uint32 if t == 32 else np.uint64
    lefts = dictionary.astype(u_dt)[left_idx.astype(np.int64)]
    if exc_pos is not None and len(exc_pos):
        flat = lefts.reshape(-1)
        flat[np.asarray(exc_pos, np.int64)] = exc_left.astype(u_dt)
        lefts = flat.reshape(left_idx.shape)
    bits = (lefts << u_dt(right_bits)) | rights.astype(u_dt)
    return bits.view(np_float)


def rd_decode_device(left_idx, rights, dictionary, right_bits: int, np_float,
                     exc_pos=None, exc_val=None):
    """Device twin: dict gather + shift/or + bitcast. f32 native; f64
    assembled in the (lo, hi) limb domain and returned as the (..., 2)
    uint32 limb image of the float64 bits (x64-free)."""
    import jax
    import jax.numpy as jnp

    dict_dev = jnp.asarray(np.asarray(dictionary, np.uint32))
    lefts = jnp.take(dict_dev, left_idx.astype(jnp.int32))
    if exc_pos is not None and len(exc_pos):
        flat = lefts.reshape(-1)
        flat = flat.at[jnp.asarray(np.asarray(exc_pos, np.int64))].set(
            jnp.asarray(np.asarray(exc_val, np.uint32)))
        lefts = flat.reshape(left_idx.shape)
    if np_float == np.float32:
        bits = (lefts << jnp.uint32(right_bits)) | rights.astype(jnp.uint32)
        return jax.lax.bitcast_convert_type(bits, jnp.float32)
    # f64: rights arrive as a (..., 2) uint32 limb image; place the left
    # part into the high bits across the limb boundary (right_bits >= 32
    # always holds for the f64 cut range 48..63)
    if right_bits < 32:
        raise ValueError("f64 ALP_RD cut keeps right_bits >= 32")
    lo = rights[..., 0]
    hi = rights[..., 1] | (lefts << jnp.uint32(right_bits - 32))
    return jnp.stack([lo, hi], axis=-1)
