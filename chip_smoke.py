#!/usr/bin/env python3
"""Run the FLT write -> device read -> query path once on an NVIDIA GPU.

    python chip_smoke.py                # phases (a), (c), (b) on one card
    python chip_smoke.py --four-cards   # phase (e) alone, over four cards
    python chip_smoke.py --rehearse     # every phase on the CPU, tiny sizes

Phases:
  (a) device: JAX must find a GPU. Prints its kind, the JAX version and
      nvidia-smi's name and power limit.
  (b) table: a TPC-H lineitem-shaped table at SF10 (59,986,052 rows, the
      spec's lineitem cardinality) generated from --seed, written with
      fio_table.write_table and answered through analytics and fio_device
      (Q6 and Q1 shapes, scan_table, ORDER BY ... LIMIT, a zone-pruned
      count, device column reads). Every answer is compared exactly with
      NumPy on the source arrays; rows/s per query (warm) is printed.
  (c) codecs: the public kernels.* decodes at seven (dtype, width) points,
      65,536 blocks each, bit-exact against ref/numpy_ref. Prints ints/s
      and the share of the card's memory bandwidth for the bytes each op
      must move. It runs before (b), while the C++ host codec that
      write_table uses compiles (about ten minutes on a fresh checkout).
  (e) --four-cards: phase (b)'s queries over a 4-card block mesh, compared
      with the one-card answers and NumPy, plus the sharded codec legs of
      __graft_entry__.dryrun_multichip.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero before that line is printed;
--rehearse never prints it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from fractions import Fraction

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SF10_ROWS = 59_986_052
CODEC_POINTS = (("u8", 3), ("u16", 9), ("u32", 3), ("u32", 11), ("u32", 25),
                ("u32", 32), ("u64", 41))
CODEC_OPS = ("unpack", "unfor_pack", "undelta_pack", "unzdelta_pack",
             "undelta_pack_orig", "unzdelta_pack_orig")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed(fn, reps: int = 1):
    """(result, seconds of the fastest of `reps` calls); results are
    host values, so the device work has finished when the clock stops."""
    best, out = None, None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, best


def device_time(fn, *args, iters: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def build_native_codec(result: dict) -> None:
    """Build (if needed) and load the C++ host codec that write_table uses;
    result["ok"] says whether it loaded. Without it write_table would take
    the NumPy encode path, many times slower, so callers treat its absence
    as a failure."""
    from fastlanes_tpu import native

    result["ok"] = native.available()


# ---------------------------------------------------------------------------
# (a) device


def setup_device(rehearse: bool, want: int):
    import jax

    from fastlanes_tpu.utils import runtime

    jax.config.update("jax_platforms", "cpu" if rehearse else "cuda")
    log(f"compile cache: {runtime.configure_compile_cache()}")
    devices = jax.devices()
    if not rehearse:
        runtime.require_gpu(devices)
    check(len(devices) >= want, f"need {want} devices, JAX found {len(devices)}")
    dev = devices[0]
    log(f"device: platform={dev.platform} kind={dev.device_kind!r} "
        f"count={len(devices)} jax={jax.__version__}")
    peak = None
    if not rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        for line in smi.stdout.strip().splitlines():
            log(f"nvidia-smi: {line.strip()}")
        peak = runtime.peak_hbm_bytes_per_s(dev.device_kind)
        log(f"peak memory bandwidth: {peak / 1e12:.2f} TB/s")
    return devices[:want], peak


# ---------------------------------------------------------------------------
# (b) table


def lineitem(n_rows: int, seed: int) -> dict:
    """TPC-H lineitem-shaped columns (spec section 4.2.3 domains). Orders
    arrive in date order, so shipdate is clustered; orderkeys are the
    spec's sparse keys (8 of every 32), each order holding 1-7 lines."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 8, n_rows // 4 + 16)
    while counts.sum() < n_rows:
        counts = np.concatenate([counts, rng.integers(1, 8, 1024)])
    ends = np.cumsum(counts)
    last = int(np.searchsorted(ends, n_rows))
    counts = counts[:last + 1].copy()
    counts[-1] -= int(ends[last]) - n_rows
    orders = np.arange(counts.size, dtype=np.int64)
    orderkey = (orders // 8) * 32 + orders % 8 + 1
    first, final = np.datetime64("1992-01-01"), np.datetime64("1998-08-02")
    span = int((final - np.timedelta64(151, "D") - first).astype(np.int64))
    orderdate = first + (orders * span // counts.size).astype("timedelta64[D]")

    quantity = rng.integers(1, 51, n_rows)
    n_parts = max(1000, n_rows // 30)  # 200,000 parts per scale factor
    partkey = rng.integers(1, n_parts + 1, n_rows)
    retail_cents = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    shipdate = (np.repeat(orderdate, counts)
                + rng.integers(1, 122, n_rows).astype("timedelta64[D]"))
    receipt = shipdate + rng.integers(1, 31, n_rows).astype("timedelta64[D]")
    current = np.datetime64("1995-06-17")
    returnflag = np.where(receipt <= current,
                          np.where(rng.random(n_rows) < 0.5, "R", "A"), "N")
    return {
        "l_orderkey": np.repeat(orderkey, counts).astype(np.uint32),
        "l_quantity": quantity,
        "l_extendedprice": (quantity * retail_cents) / 100.0,
        "l_discount": rng.integers(0, 11, n_rows) / 100.0,
        "l_tax": rng.integers(0, 9, n_rows) / 100.0,
        "l_returnflag": returnflag,
        "l_linestatus": np.where(shipdate > current, "O", "F"),
        "l_shipdate": shipdate,
    }


def exact_sum(x: np.ndarray) -> float:
    """The correctly rounded sum of float64 values: integer mantissas
    summed per binary exponent, combined as one exact fraction."""
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return 0.0
    m, e = np.frexp(x)
    mant = (m * (1 << 53)).astype(np.int64)
    total = Fraction(0)
    for ex in np.unique(e):
        sel = mant[e == ex]
        hi, lo = sel >> 26, sel & ((1 << 26) - 1)
        s = int(hi.sum()) * (1 << 26) + int(lo.sum())
        total += Fraction(s) * Fraction(2) ** (int(ex) - 53)
    return float(total)


def numpy_stats(col: np.ndarray) -> dict:
    if col.dtype.kind == "U":
        uniq = np.unique(col)
        return {"sum": None, "min": str(uniq[0]), "max": str(uniq[-1]),
                "count": int(col.size)}
    if col.dtype.kind == "M":
        col = col.view(np.int64)
    if col.dtype.kind == "f":
        return {"sum": exact_sum(col), "min": float(col.min()),
                "max": float(col.max()), "count": int(col.size)}
    x = col.astype(np.int64)  # every integer column here fits int64
    # 32-bit halves summed apart cannot overflow for < 2^31 rows
    total = int((x >> 32).sum()) * (1 << 32) + int((x & 0xFFFFFFFF).sum())
    return {"sum": total, "min": int(col.min()), "max": int(col.max()),
            "count": int(col.size)}


def same_stats(got: dict, want: dict, what: str) -> None:
    for key in ("sum", "min", "max", "count"):
        check(got[key] == want[key],
              f"{what}: {key} {got[key]!r} != NumPy {want[key]!r}")


def q6_preds():
    return [("l_shipdate", "ge", np.datetime64("1994-01-01")),
            ("l_shipdate", "lt", np.datetime64("1995-01-01")),
            ("l_discount", "ge", 0.05), ("l_discount", "le", 0.07),
            ("l_quantity", "lt", 24)]


COUNT_BEFORE = np.datetime64("1993-01-01")


def table_queries(path: str, mesh=None) -> dict:
    """Phase (b)'s queries through the public entry points; returns
    {name: (answer, warm seconds, cold seconds)}."""
    from fastlanes_tpu import analytics as an
    from fastlanes_tpu import fio_device as fd

    queries = {
        "q6_scan_where_multi": lambda: an.scan_where_multi(
            path, q6_preds(), column="l_extendedprice", mesh=mesh),
        "q1_group_stats": lambda: an.group_stats(
            path, "l_returnflag", "l_quantity", mesh=mesh),
        "scan_table": lambda: an.scan_table(path, mesh=mesh),
        "select_top10": lambda: an.select(
            path, columns=["l_orderkey", "l_extendedprice"],
            order_by="l_extendedprice", desc=True, limit=10, mesh=mesh),
        "count_where_pruned": lambda: an.count_where(
            path, "lt", COUNT_BEFORE, column="l_shipdate", mesh=mesh),
        "read_l_orderkey": lambda: np.asarray(fd.read_column_device(
            path, "l_orderkey", mesh=mesh)),
        "read_l_shipdate": lambda: np.asarray(fd.read_column_device(
            path, "l_shipdate", mesh=mesh)),
    }
    out = {}
    for name, fn in queries.items():
        _, cold = timed(fn)
        ans, warm = timed(fn)
        out[name] = (ans, warm, cold)
    return out


def check_answers(answers: dict, cols: dict, label: str) -> None:
    n = cols["l_orderkey"].size
    sd, disc = cols["l_shipdate"], cols["l_discount"]
    qty, price = cols["l_quantity"], cols["l_extendedprice"]

    m6 = ((sd >= np.datetime64("1994-01-01")) & (sd < np.datetime64("1995-01-01"))
          & (disc >= 0.05) & (disc <= 0.07) & (qty < 24))
    same_stats(answers["q6_scan_where_multi"][0], numpy_stats(price[m6]),
               f"{label} q6")

    q1 = answers["q1_group_stats"][0]
    flags = np.unique(cols["l_returnflag"])
    check(sorted(q1) == sorted(flags.tolist()), f"{label} q1 groups {sorted(q1)}")
    for flag in flags:
        same_stats(q1[flag], numpy_stats(qty[cols["l_returnflag"] == flag]),
                   f"{label} q1 group {flag}")

    scans = answers["scan_table"][0]
    check(sorted(scans) == sorted(cols), f"{label} scan_table columns")
    for name, col in cols.items():
        same_stats(scans[name], numpy_stats(col), f"{label} scan_table {name}")

    top = answers["select_top10"][0]
    k = min(10, n)
    order = np.argsort(-price, kind="stable")
    want_prices = price[order[:k]]
    check(np.array_equal(top["l_extendedprice"], want_prices),
          f"{label} top-10 prices")
    # ties at the 10th price may take any of the tied rows
    cand = set(zip(cols["l_orderkey"][price >= want_prices[-1]].tolist(),
                   price[price >= want_prices[-1]].tolist()))
    check(all(pair in cand for pair in zip(top["l_orderkey"].tolist(),
                                           top["l_extendedprice"].tolist())),
          f"{label} top-10 rows")

    check(answers["count_where_pruned"][0] == int((sd < COUNT_BEFORE).sum()),
          f"{label} count_where")

    check(np.array_equal(answers["read_l_orderkey"][0], cols["l_orderkey"]),
          f"{label} read l_orderkey")
    sd_limbs = sd.view(np.int64).view(np.uint32).reshape(-1, 2)
    check(np.array_equal(answers["read_l_shipdate"][0], sd_limbs),
          f"{label} read l_shipdate")


def report_queries(answers: dict, n_rows: int, label: str) -> None:
    for name, (_, warm, cold) in answers.items():
        log(f"{label} {name}: warm {warm:.3f} s = {n_rows / warm:.4g} rows/s "
            f"(first call {cold:.3f} s, compile included)")


def write_lineitem(path: str, n_rows: int, seed: int, chunk_blocks: int):
    from fastlanes_tpu import fio_table, native

    check(native.available(), "the C++ host codec did not build or load")
    cols, gen_s = timed(lambda: lineitem(n_rows, seed))
    header, write_s = timed(lambda: fio_table.write_table(
        path, cols, chunk_blocks=chunk_blocks))
    raw = sum(c.nbytes for c in cols.values())
    size = os.path.getsize(path)
    log(f"lineitem: {n_rows} rows, generated in {gen_s:.1f} s, written in "
        f"{write_s:.1f} s; {raw / 1e9:.3f} GB raw -> {size / 1e9:.3f} GB FLT")
    for name, col in header["columns"].items():
        codecs = sorted({c["codec"] for c in col["chunks"]})
        widths = sorted({c["width"] for c in col["chunks"]})
        log(f"  {name}: {col['dtype']} {col.get('vtype') or ''} "
            f"codecs={codecs} widths={widths[:4]}{'...' if len(widths) > 4 else ''}")
    return cols


def table_phase(path: str, n_rows: int, seed: int, chunk_blocks: int) -> None:
    cols = write_lineitem(path, n_rows, seed, chunk_blocks)
    answers = table_queries(path)
    check_answers(answers, cols, "1 card")
    report_queries(answers, n_rows, "1 card")


# ---------------------------------------------------------------------------
# (c) codecs


def _rand(rng, shape, dtype):
    return rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype,
                        endpoint=True)


def codec_inputs(rng, dt: str, w: int, n_blocks: int):
    """Host (packed, per-block base, FoR reference) for one point; any bit
    pattern is a valid packed payload."""
    from fastlanes_tpu.core import layout

    np_dt = layout.np_dtype(dt)
    packed = _rand(rng, (n_blocks, layout.packed_len(dt, w)), np_dt)
    base = _rand(rng, (n_blocks, layout.lanes(dt)), np_dt)
    reference = int(_rand(rng, (), np_dt))
    return packed, base, reference


def device_form(arr: np.ndarray):
    import jax.numpy as jnp

    if arr.dtype == np.uint64:  # u64 rides (..., 2) uint32 limb images
        shape = arr.shape
        return jnp.asarray(arr.reshape(-1).view(np.uint32).reshape(*shape, 2))
    return jnp.asarray(arr)


def host_form(out, dt: str) -> np.ndarray:
    """Device result -> host array in the oracle's dtype."""
    if dt == "u64":
        lo, hi = (np.asarray(o).astype(np.uint64) for o in out)
        return lo | (hi << np.uint64(32))
    return np.asarray(out)


def codec_refs(op: str, packed, base, reference, w: int, dt: str):
    from fastlanes_tpu import transforms
    from fastlanes_tpu.ref import numpy_ref as ref

    if op == "unpack":
        return ref.unpack(packed, w, dt)
    if op == "unfor_pack":
        return ref.unfor_pack(packed, reference, w, dt)
    if op.startswith("undelta"):
        out = ref.undelta_pack(packed, base, w, dt)
    else:
        codes = ref.unpack(packed, w, dt)
        deltas = transforms.zigzag_decode_np(codes).view(codes.dtype)
        out = ref.undelta(deltas, base, dt)
    return ref.untranspose(out, dt) if op.endswith("_orig") else out


def codec_fn(op: str, w: int, dt: str):
    import jax

    from fastlanes_tpu import kernels

    limb = dt == "u64"
    entry = getattr(kernels, op)
    if op == "unpack":
        return jax.jit(lambda p, b, r: entry(p, w, dt, planes=limb))
    if op == "unfor_pack":
        return jax.jit(lambda p, b, r: entry(p, r, w, dt, planes=limb))
    return jax.jit(lambda p, b, r: entry(p, b, w, dt, planes=limb))


def moved_bytes(op: str, dt: str, w: int, n_blocks: int) -> int:
    from fastlanes_tpu.core import layout

    item = layout.np_dtype(dt).itemsize
    n = n_blocks * (layout.packed_len(dt, w) + layout.BLOCK)
    if "delta" in op:
        n += n_blocks * layout.lanes(dt)
    return n * item


def codec_phase(n_blocks: int, seed: int, peak) -> None:
    from fastlanes_tpu.core import layout

    rng = np.random.default_rng(seed + 1)
    for dt, w in CODEC_POINTS:
        packed, base, reference = codec_inputs(rng, dt, w, n_blocks)
        args = (device_form(packed), device_form(base),
                device_form(np.asarray(reference, layout.np_dtype(dt))))
        for op in CODEC_OPS:
            fn = codec_fn(op, w, dt)
            got = host_form(fn(*args), dt)
            want = codec_refs(op, packed, base, reference, w, dt)
            check(np.array_equal(got, want), f"{op} {dt} W={w} not bit-exact")
            secs = device_time(fn, *args)
            rate = moved_bytes(op, dt, w, n_blocks) / secs
            share = f"{rate / peak:.3f}" if peak else "not measured"
            log(f"codec {op} {dt} W={w}: {n_blocks * layout.BLOCK / secs:.4g} "
                f"ints/s, {rate / 1e9:.1f} GB/s, bandwidth share {share}")
        del packed, base, args


# ---------------------------------------------------------------------------
# (e) four cards


def _spec(arr):
    return getattr(arr.sharding, "spec", arr.sharding)


def four_card_phase(path: str, n_rows: int, seed: int, chunk_blocks: int,
                    devices) -> None:
    from fastlanes_tpu import parallel

    cols = write_lineitem(path, n_rows, seed, chunk_blocks)
    mesh = parallel.make_mesh(len(devices))
    one = table_queries(path)
    check_answers(one, cols, "1 card")
    four = table_queries(path, mesh=mesh)
    check_answers(four, cols, f"{len(devices)} cards")
    for name in one:
        a, b = one[name][0], four[name][0]
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else json.dumps(a, sort_keys=True, default=repr)
                == json.dumps(b, sort_keys=True, default=repr))
        check(same, f"{name}: {len(devices)}-card answer differs from 1 card")
    report_queries(one, n_rows, "1 card")
    report_queries(four, n_rows, f"{len(devices)} cards")

    # a read of whole chunks whose block count the card count divides
    # leaves one distinct shard on every card; other counts cannot be
    # sharded evenly, so JAX gathers them onto every card
    from fastlanes_tpu import fio_device as fd

    span = chunk_blocks * len(devices)
    check(span * 1024 <= n_rows, f"need {span * 1024} rows for the check")
    blocks = fd.read_column_device(path, "l_orderkey", 0, span, mesh=mesh)
    holders = {s.device for s in blocks.addressable_shards}
    check(holders == set(devices), f"sharded column read landed on {holders}")
    check(not blocks.sharding.is_fully_replicated,
          "sharded column read is replicated, not sharded")
    check(np.array_equal(np.asarray(blocks).reshape(-1),
                         cols["l_orderkey"][:span * 1024]), "sharded block read")
    full = fd.read_column_device(path, "l_orderkey", mesh=mesh)
    log(f"column read over the mesh: {span} blocks {_spec(blocks)} on "
        f"{len(holders)} devices; full read of {-(-n_rows // 1024)} blocks "
        f"{_spec(full)}, replicated={full.sharding.is_fully_replicated}")

    import __graft_entry__

    __graft_entry__.dryrun_multichip(len(devices))


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=None,
                    help=f"lineitem rows (default {SF10_ROWS}, SF10)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase (e) alone over four cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at a tiny size; prints no result")
    args = ap.parse_args(argv)
    rows = args.rows or (20_000 if args.rehearse else SF10_ROWS)
    blocks = 16 if args.rehearse else 65536
    chunk = 4 if args.rehearse else 1024  # blocks per FLT chunk
    if args.rehearse:
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=4")

    sys.path.insert(0, ROOT)
    with phase("a: device"):
        devices, peak = setup_device(args.rehearse, 4 if args.four_cards else 1)

    work = os.path.join(ROOT, ".smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, f"lineitem_{rows}.flt")
    try:
        if args.four_cards:
            with phase("e: table over four cards"):
                four_card_phase(path, rows, args.seed, chunk, devices)
        else:
            # the host codec compiles on first use (minutes on a fresh
            # checkout); let g++ run beside phase (c), which does not need it
            built = {}
            builder = threading.Thread(target=build_native_codec,
                                       args=(built,))
            builder.start()
            try:
                with phase("c: codecs"):
                    codec_phase(blocks, args.seed, peak)
            finally:
                builder.join()
            check(built.get("ok"), "the C++ host codec did not build or load")
            with phase("b: lineitem table"):
                table_phase(path, rows, args.seed, chunk)
    finally:
        if os.path.exists(path):
            os.remove(path)
    if args.rehearse:
        log("rehearsal passed (CPU; no device result)")
        return 0
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
