"""Command-line front end for the FLT file format.

    python -m fastlanes_tpu compress   raw.npy column.flt [--codec auto] [--chunk-blocks N]
    python -m fastlanes_tpu decompress column.flt raw.npy [--start B] [--stop B]
    python -m fastlanes_tpu inspect    column.flt
    python -m fastlanes_tpu get        column.flt BLOCK INDEX
    python -m fastlanes_tpu scan       column.flt [--where gt:100] [--top K] [--distinct]
    python -m fastlanes_tpu scan       table.flt              # every column, one pass
    python -m fastlanes_tpu scan       s0.flt s1.flt --column q --group-by cur   # dataset
    python -m fastlanes_tpu select     table.flt rows.npz --where cur:eq:EUR \
                                       --order-by price --desc --limit 10
    python -m fastlanes_tpu join       fact.flt dim.flt out.npz --on key
    python -m fastlanes_tpu import     data.parquet table.flt [--batch-rows N]
    python -m fastlanes_tpu export     table.flt data.parquet
    python -m fastlanes_tpu recompress table.flt smaller.flt --chunk-blocks 4096

The role the `vortex` CLI plays around the Rust crate: compress whole
columns to disk, decode block ranges, random-access single elements.
Input/output is .npy — flat integer vectors of ANY length (the partial tail
block is padded internally and reads trim to the exact original length) or
pre-blocked (B, 1024) batches. Compression runs on the host (C++ codec when
built, NumPy oracle otherwise); `decompress --device` decodes on the
accelerator via fastlanes_tpu.fio_device. `bench` is the single-block
latency micro-bench (the reference's criterion bench shape,
benches/bitpacking.rs:13-63).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import fio
from .core import layout


def _as_column(arr: np.ndarray) -> np.ndarray:
    """Flat vectors of any length (tail block padded by fio) or (B, 1024)."""
    if arr.ndim == 1:
        return arr
    if arr.ndim == 2 and arr.shape[1] == layout.BLOCK:
        return arr
    raise SystemExit(f"input must be flat or (B, {layout.BLOCK}), got shape {arr.shape}")


def _cmd_compress(args) -> int:
    arr = np.load(args.input)
    is_float = np.issubdtype(arr.dtype, np.floating)
    if not np.issubdtype(arr.dtype, np.integer) and not is_float:
        raise SystemExit(f"FastLanes compresses integers and floats, got {arr.dtype}")
    if is_float and args.dtype:
        raise SystemExit("float columns choose their own wire dtype; drop --dtype")
    if args.dtype:
        # explicit wire dtype: signed inputs reinterpret mod 2^T
        column = _as_column(arr).astype(layout.np_dtype(args.dtype))
    else:
        # unsigned passes through; signed is zigzag-transformed by write_file
        column = _as_column(arr)
    header = fio.write_file(args.output, column, dtype=args.dtype,
                            codec=args.codec, chunk_blocks=args.chunk_blocks)
    dtype = header["dtype"]  # the wire dtype write_file actually chose
    raw = column.nbytes
    import os
    packed = os.path.getsize(args.output)
    print(json.dumps({
        "file": args.output, "dtype": dtype, "n_blocks": header["n_blocks"],
        "raw_bytes": raw, "file_bytes": packed,
        "ratio": round(raw / max(packed, 1), 3),
        "chunks": [{"codec": c["codec"], "width": c["width"]} for c in header["chunks"][:8]],
    }))
    return 0


def _from_device(arr, header) -> np.ndarray:
    """Device decode result -> the host array the CPU path would produce.
    u64 columns come back as (..., 2) uint32 limb images; rejoin the limbs
    and restore signedness for transformed (originally signed) columns.
    f64 ALP_RD columns come back as the limb image of the float64 bits."""
    from .fio_device import NullableColumn

    if isinstance(arr, NullableColumn):
        values = _from_device(arr.values, header)
        return np.ma.MaskedArray(values, mask=~np.asarray(arr.valid))
    out = np.asarray(arr)
    if header["dtype"] == "u64" and out.dtype != np.float64:
        wide = np.ascontiguousarray(out).view(np.uint64)[..., 0]
        if header.get("vtype") == "f64":
            wide = wide.view(np.float64)  # ALP_RD: raw float64 bit pattern
        elif header.get("transform") in ("zigzag", "viewu"):
            wide = wide.view(np.int64)  # limb image carries the int64 bits
        return wide
    return out


def _cmd_decompress(args) -> int:
    full = args.start == 0 and args.stop is None
    if getattr(args, "device", False):
        from . import fio_device

        if full:
            out = _from_device(fio_device.read_file_device(args.input),
                               fio.read_header(args.input))
        else:
            out = _from_device(
                fio_device.read_blocks_device(args.input, args.start, args.stop),
                fio.read_header(args.input))
    elif full:
        out = fio.read_file(args.input)  # flat columns come back trimmed
    else:
        out = fio.read_blocks(args.input, args.start, args.stop)
    extra = {}
    if isinstance(out, np.ma.MaskedArray):
        # .npy cannot hold a mask: values here, validity alongside
        valid_path = args.output + ".valid.npy"
        np.save(valid_path, ~np.ma.getmaskarray(out))
        extra["valid_file"] = valid_path
        out = np.asarray(np.ma.getdata(out))
    np.save(args.output, out)
    print(json.dumps({"file": args.output, "shape": list(out.shape),
                      "dtype": str(out.dtype), **extra}))
    return 0


def _cmd_compress_table(args) -> int:
    from . import fio_table

    data = np.load(args.input)
    if not hasattr(data, "files"):
        raise SystemExit(
            f"{args.input} is a single array; compress-table needs an .npz "
            "of named columns (use plain 'compress' for one column)")
    valid_of = {name[: -len("__valid")]: data[name] for name in data.files
                if name.endswith("__valid")}
    columns = {}
    for name in data.files:
        if name.endswith("__valid"):
            continue  # companion validity mask (npz cannot hold np.ma masks)
        arr = data[name]
        if not (np.issubdtype(arr.dtype, np.integer)
                or np.issubdtype(arr.dtype, np.floating)
                or arr.dtype.kind in ("U", "S", "b", "M", "m")):
            raise SystemExit(f"column {name!r} is {arr.dtype}; FastLanes "
                             "compresses integers, floats, strings, bools "
                             "and datetime64/timedelta64")
        if name in valid_of:
            arr = np.ma.MaskedArray(arr, mask=~valid_of[name].astype(bool))
        # signed -> zigzag/viewu transform, float -> ALP, strings ->
        # sorted-dictionary codes, X + X__valid -> nullable column
        columns[name] = arr
    header = fio_table.write_table(args.output, columns, codec=args.codec,
                                   chunk_blocks=args.chunk_blocks)
    import os
    raw = sum(int(c.nbytes) for c in columns.values())
    print(json.dumps({
        "file": args.output, "columns": sorted(columns),
        "raw_bytes": raw, "file_bytes": os.path.getsize(args.output),
        "ratio": round(raw / max(os.path.getsize(args.output), 1), 3),
    }))
    return 0


def _cmd_decompress_table(args) -> int:
    from . import fio_table

    names = ([c.strip() for c in args.columns.split(",") if c.strip()]
             if args.columns else None)
    table = fio_table.read_table(args.input, names=names)
    out = {}
    for k, v in table.items():
        if isinstance(v, np.ma.MaskedArray):
            # npz cannot hold masks: values + companion X__valid column
            out[k] = np.asarray(np.ma.getdata(v))
            out[f"{k}__valid"] = ~np.ma.getmaskarray(v)
        else:
            out[k] = v
    out_path = args.output if args.output.endswith(".npz") else args.output + ".npz"
    np.savez(out_path, **out)  # savez appends .npz itself; report the real name
    print(json.dumps({"file": out_path,
                      "columns": {k: list(v.shape) for k, v in out.items()}}))
    return 0


def _cmd_inspect(args) -> int:
    with open(args.input, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"FLTTAB1"):
        from . import fio_table

        header = fio_table.read_table_header(args.input)
        print(json.dumps({
            "kind": "table",
            "columns": {name: {"dtype": c["dtype"], "n_blocks": c["n_blocks"],
                               **({"n_values": c["n_values"]} if "n_values" in c else {}),
                               **({"vtype": c["vtype"]} if "vtype" in c else {}),
                               **({"n_null": c["nulls"]["n_null"]}
                                  if "nulls" in c else {}),
                               "codecs": sorted({ch["codec"] for ch in c["chunks"]})}
                        for name, c in header["columns"].items()},
        }, indent=2))
        return 0
    header = fio.read_header(args.input)
    widths = [c["width"] for c in header["chunks"]]
    codecs = {}
    for c in header["chunks"]:
        codecs[c["codec"]] = codecs.get(c["codec"], 0) + 1
    print(json.dumps({
        "dtype": header["dtype"], "n_blocks": header["n_blocks"],
        **({"vtype": header["vtype"]} if "vtype" in header else {}),
        "chunk_blocks": header["chunk_blocks"], "n_chunks": len(header["chunks"]),
        "codecs": codecs,
        "width_min": min(widths) if widths else None,
        "width_max": max(widths) if widths else None,
        "payload_bytes": sum(c["nbytes"] for c in header["chunks"]),
    }, indent=2))
    return 0


def _cmd_get(args) -> int:
    val = fio.read_single(args.input, args.block, args.index)
    if np.issubdtype(np.asarray(val).dtype, np.floating):
        print(repr(val.item()))
    else:
        print(int(val))
    return 0


def _cmd_scan(args) -> int:
    """Fused query over compressed file(s): sum/min/max/count, optional
    filtered count — decoded data never materializes (analytics module).
    Several inputs scan as one sharded dataset."""
    from . import analytics

    paths = args.input
    args.input = paths[0] if len(paths) == 1 else paths
    with open(paths[0], "rb") as f:
        is_table = f.read(8).startswith(b"FLTTAB1")
    if args.group_by:
        if not is_table or args.column is None:
            raise SystemExit("--group-by needs a table file and --column")
        preds = []
        if args.where:  # GROUP BY ... WHERE: predicate before grouping
            try:
                op, _, value = args.where.partition(":")
                if op in ("in", "notin"):
                    v = [_parse_where_value(x) for x in value.split(",")]
                else:
                    v = _parse_where_value(value)
                preds = [(args.where_column or args.column, op, v)]
            except ValueError as e:
                raise SystemExit(f"bad --where {args.where!r}: {e}")
        groups = analytics.group_stats(args.input, args.group_by,
                                       args.column, preds=preds)
        print(json.dumps({str(g): s for g, s in groups.items()}))
        return 0
    if is_table and args.column is None:
        # no column named: single-pass fused scan of EVERY column
        if args.where:
            raise SystemExit("--where on a table file needs --column")
        print(json.dumps(analytics.scan_table(args.input)))
        return 0
    stats = analytics.scan_column(args.input, column=args.column)
    if args.top:
        stats["top"] = analytics.top_k(args.input, column=args.column,
                                       k=args.top)
    if args.bottom:
        stats["bottom"] = analytics.top_k(args.input, column=args.column,
                                          k=args.bottom, largest=False)
    if args.distinct:
        vals = analytics.distinct(args.input, column=args.column)
        stats["n_distinct"] = int(vals.size)
        if vals.size <= 64:
            stats["distinct"] = [v.item() if hasattr(v, "item") else v
                                 for v in vals]
    if args.value_counts:
        try:
            stats["value_counts"] = analytics.value_counts(
                args.input, column=args.column)
        except ValueError as e:
            raise SystemExit(f"--value-counts: {e}")
    if args.quantile:
        from . import analytics as _an

        for qq in args.quantile:
            stats[f"q{qq}"] = _an.quantile(args.input, column=args.column,
                                           q=qq)
    if args.where:
        try:
            op, _, value = args.where.partition(":")
            if op in ("in", "notin"):  # VALUE is a comma list
                v = [_parse_where_value(x) for x in value.split(",")]
            else:
                v = _parse_where_value(value)
            filtered = analytics.scan_where(args.input, op, v,
                                            column=args.column,
                                            where=args.where_column)
            stats[f"count_{op}_{value}"] = filtered["count"]
            stats["where"] = dict(op=op, value=v,
                                  column=args.where_column or args.column,
                                  **filtered)
        except ValueError as e:
            raise SystemExit(f"bad --where {args.where!r}: {e}")
    print(json.dumps(stats))
    return 0


def _parse_where_value(value: str):
    try:  # numeric probe; anything else is a string probe
        return float(value) if "." in value else int(value)
    except ValueError:
        return value


def _cmd_select(args) -> int:
    """SELECT columns FROM table WHERE p1 AND p2 ... [LIMIT n] -> .npz
    (projection + selection pushdown; analytics.select)."""
    from . import analytics

    paths = args.input
    args.input = paths[0] if len(paths) == 1 else paths
    preds = []
    for w in args.where or []:
        parts = w.split(":", 2)
        if len(parts) != 3:
            raise SystemExit(f"--where takes COLUMN:OP:VALUE, got {w!r}")
        if parts[1] in ("in", "notin"):  # VALUE is a comma list
            v = [_parse_where_value(x) for x in parts[2].split(",")]
        else:
            v = _parse_where_value(parts[2])
        preds.append((parts[0], parts[1], v))
    columns = ([c.strip() for c in args.columns.split(",") if c.strip()]
               if args.columns else None)
    try:
        rows = analytics.select(args.input, columns=columns, preds=preds,
                                limit=args.limit, order_by=args.order_by,
                                desc=args.desc)
    except (ValueError, KeyError) as e:
        raise SystemExit(f"error: {e}")
    out = {}
    n_rows = 0
    for k, v in rows.items():
        n_rows = len(v)
        if isinstance(v, np.ma.MaskedArray):
            out[k] = np.asarray(np.ma.getdata(v))
            out[f"{k}__valid"] = ~np.ma.getmaskarray(v)
        else:
            out[k] = v
    out_path = (args.output if args.output.endswith(".npz")
                else args.output + ".npz")
    np.savez(out_path, **out)
    print(json.dumps({"file": out_path, "rows": n_rows,
                      "columns": sorted(rows)}))
    return 0


def _cmd_recompress(args) -> int:
    """Rewrite an FLT file/table with a different codec or chunking
    (compaction): decode on the host, re-encode with the new settings.
    Logical types, nulls, strings and transforms all survive the trip."""
    import os

    with open(args.input, "rb") as f:
        is_table = f.read(8).startswith(b"FLTTAB1")
    if is_table:
        from . import fio_table

        table = fio_table.read_table(args.input)
        fio_table.write_table(args.output, table, codec=args.codec,
                              chunk_blocks=args.chunk_blocks)
    else:
        values = fio.read_file(args.input)
        fio.write_file(args.output, values, codec=args.codec,
                       chunk_blocks=args.chunk_blocks)
    print(json.dumps({
        "file": args.output,
        "input_bytes": os.path.getsize(args.input),
        "file_bytes": os.path.getsize(args.output),
    }))
    return 0


def _cmd_join(args) -> int:
    """Dimension join (left table(s) enriched from a unique-keyed right
    table) -> .npz; analytics.join."""
    from . import analytics

    preds = []
    for w in args.where or []:
        parts = w.split(":", 2)
        if len(parts) != 3:
            raise SystemExit(f"--where takes COLUMN:OP:VALUE, got {w!r}")
        if parts[1] in ("in", "notin"):
            v = [_parse_where_value(x) for x in parts[2].split(",")]
        else:
            v = _parse_where_value(parts[2])
        preds.append((parts[0], parts[1], v))
    cols = ([c.strip() for c in args.columns.split(",") if c.strip()]
            if args.columns else None)
    rcols = ([c.strip() for c in args.right_columns.split(",") if c.strip()]
             if args.right_columns else None)
    left = args.left[0] if len(args.left) == 1 else args.left
    try:
        rows = analytics.join(left, args.right, on=args.on, columns=cols,
                              right_columns=rcols, preds=preds,
                              how=args.how, limit=args.limit)
    except (ValueError, KeyError) as e:
        raise SystemExit(f"error: {e}")
    out = {}
    n_rows = 0
    for k, v in rows.items():
        n_rows = len(v)
        if isinstance(v, np.ma.MaskedArray):
            out[k] = np.asarray(np.ma.getdata(v))
            out[f"{k}__valid"] = ~np.ma.getmaskarray(v)
        else:
            out[k] = v
    out_path = (args.output if args.output.endswith(".npz")
                else args.output + ".npz")
    np.savez(out_path, **out)
    print(json.dumps({"file": out_path, "rows": n_rows,
                      "columns": sorted(rows)}))
    return 0


def _cmd_import(args) -> int:
    """parquet/csv -> FLT table (Arrow interop; type inference, nulls,
    strings, temporal types all preserved)."""
    import os

    from . import interop

    ext = args.input.rsplit(".", 1)[-1].lower()
    try:
        if ext in ("parquet", "pq"):
            interop.parquet_to_flt(args.input, args.output,
                                   codec=args.codec,
                                   chunk_blocks=args.chunk_blocks,
                                   batch_rows=args.batch_rows)
        elif ext == "csv":
            interop.csv_to_flt(args.input, args.output, codec=args.codec,
                               chunk_blocks=args.chunk_blocks)
        else:
            raise SystemExit(f"import takes .parquet/.pq/.csv, got {ext!r}")
    except ImportError as e:
        raise SystemExit(f"error: {e}")
    from . import fio_table

    header = fio_table.read_table_header(args.output)
    print(json.dumps({
        "file": args.output, "columns": sorted(header["columns"]),
        "input_bytes": os.path.getsize(args.input),
        "file_bytes": os.path.getsize(args.output),
    }))
    return 0


def _cmd_export(args) -> int:
    """FLT table -> parquet."""
    import os

    from . import interop

    try:
        interop.flt_to_parquet(args.input, args.output)
    except ImportError as e:
        raise SystemExit(f"error: {e}")
    print(json.dumps({"file": args.output,
                      "file_bytes": os.path.getsize(args.output)}))
    return 0


def _cmd_bench(args) -> int:
    """Single-block latency micro-bench — the shape of the reference's
    criterion benches (reference benches/bitpacking.rs:13-63): pack one
    1024-value block, unpack it, and unpack_single over all 1024 indices,
    reporting median ns/op per host path (C++ codec and NumPy oracle)."""
    import time

    from . import native
    from .ref import numpy_ref as npref

    dt = layout.canon_dtype(args.dtype)
    t = layout.bit_width(dt)
    w = args.width
    if not 0 <= w <= t:
        raise SystemExit(f"width {w} out of range for {dt} (0..{t})")
    rng = np.random.default_rng(0)
    block = rng.integers(0, 1 << max(w, 1), (1, layout.BLOCK),
                         dtype=np.uint64).astype(layout.np_dtype(dt))
    idx = np.arange(layout.BLOCK, dtype=np.int64)

    def med_ns(fn, repeat):
        fn()  # warm
        times = []
        for _ in range(repeat):
            t0 = time.perf_counter_ns()
            fn()
            times.append(time.perf_counter_ns() - t0)
        return int(np.median(times))

    paths = {"numpy_oracle": npref}
    if native.available():
        paths["native_cpp"] = native
    out = {"dtype": dt, "width": w, "block_values": layout.BLOCK}
    for name, mod in paths.items():
        packed = mod.pack(block, w, dt)
        out[name] = {
            "pack_ns": med_ns(lambda: mod.pack(block, w, dt), args.repeat),
            "unpack_ns": med_ns(lambda: mod.unpack(packed, w, dt), args.repeat),
            "unpack_single_all_ns": med_ns(
                lambda: mod.unpack_single(packed, w, idx, dt), args.repeat),
        }
    print(json.dumps(out, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fastlanes_tpu", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="compress a .npy integer column to .flt")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--codec", default="auto",
                   choices=["auto", "bitpack", "ffor", "delta", "zdelta",
                            "rle", "dict", "alp", "alprd"])
    c.add_argument("--dtype", default=None, choices=list(layout.DTYPES))
    c.add_argument("--chunk-blocks", type=int, default=1024)
    c.set_defaults(fn=_cmd_compress)

    d = sub.add_parser("decompress", help="decode an .flt file (or block range) to .npy")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--start", type=int, default=0)
    d.add_argument("--stop", type=int, default=None)
    d.add_argument("--device", action="store_true",
                   help="decode on the accelerator (XLA) instead of the host codec")
    d.set_defaults(fn=_cmd_decompress)

    i = sub.add_parser("inspect", help="print .flt / table header summary")
    i.add_argument("input")
    i.set_defaults(fn=_cmd_inspect)

    ct = sub.add_parser("compress-table",
                        help="compress an .npz of named integer columns")
    ct.add_argument("input")
    ct.add_argument("output")
    ct.add_argument("--codec", default="auto",
                    choices=["auto", "bitpack", "ffor", "delta", "zdelta", "rle", "dict"])
    ct.add_argument("--chunk-blocks", type=int, default=1024)
    ct.set_defaults(fn=_cmd_compress_table)

    dt = sub.add_parser("decompress-table", help="decode a table file to .npz")
    dt.add_argument("input")
    dt.add_argument("output")
    dt.add_argument("--columns", default=None,
                    help="comma-separated subset (default: all)")
    dt.set_defaults(fn=_cmd_decompress_table)

    g = sub.add_parser("get", help="random-access one element: get FILE BLOCK INDEX")
    g.add_argument("input")
    g.add_argument("block", type=int)
    g.add_argument("index", type=int)
    g.set_defaults(fn=_cmd_get)

    sc = sub.add_parser("scan",
                        help="fused sum/min/max/count query over compressed "
                             "file(s) — several inputs scan as one dataset")
    sc.add_argument("input", nargs="+")
    sc.add_argument("--column", default=None, help="table files: column name")
    sc.add_argument("--where", default=None, metavar="OP:VALUE",
                    help="also aggregate rows matching OP:VALUE "
                         "(OP in lt/le/gt/ge/eq/ne): filtered "
                         "sum/min/max/count")
    sc.add_argument("--where-column", default=None,
                    help="table files: evaluate the predicate on this "
                         "column instead of the aggregated one")
    sc.add_argument("--group-by", default=None, metavar="KEY_COLUMN",
                    help="table files: per-group stats of --column grouped "
                         "by this integer or string column")
    sc.add_argument("--top", type=int, default=0, metavar="K",
                    help="also report the K largest values")
    sc.add_argument("--bottom", type=int, default=0, metavar="K",
                    help="also report the K smallest values")
    sc.add_argument("--distinct", action="store_true",
                    help="also report the distinct-value count (and the "
                         "values themselves when there are <= 64)")
    sc.add_argument("--value-counts", action="store_true",
                    help="also report exact {value: count} (low-cardinality "
                         "integer/string columns)")
    sc.add_argument("--quantile", type=float, action="append", metavar="Q",
                    help="also report the EXACT Q-quantile (repeatable; "
                         "lower interpolation)")
    sc.set_defaults(fn=_cmd_scan)

    se = sub.add_parser("select",
                        help="materialize rows matching ANDed predicates "
                             "to .npz (projection + selection pushdown)")
    se.add_argument("input", nargs="+")
    se.add_argument("output")
    se.add_argument("--where", action="append", metavar="COLUMN:OP:VALUE",
                    help="repeatable; OP in lt/le/gt/ge/eq/ne; string "
                         "values compare lexicographically")
    se.add_argument("--columns", default=None,
                    help="comma-separated projection (default: all)")
    se.add_argument("--limit", type=int, default=None)
    se.add_argument("--order-by", default=None, metavar="COLUMN",
                    help="sort the result; with --limit this is a true "
                         "ORDER BY ... LIMIT pushdown (per-chunk top-k)")
    se.add_argument("--desc", action="store_true",
                    help="descending order (with --order-by)")
    se.set_defaults(fn=_cmd_select)

    rc = sub.add_parser("recompress",
                        help="rewrite an .flt file/table with a different "
                             "codec or chunking (compaction)")
    rc.add_argument("input")
    rc.add_argument("output")
    rc.add_argument("--codec", default="auto",
                    choices=["auto", "bitpack", "ffor", "delta", "zdelta",
                             "rle", "dict"])
    rc.add_argument("--chunk-blocks", type=int, default=1024)
    rc.set_defaults(fn=_cmd_recompress)

    jo = sub.add_parser("join",
                        help="enrich left table(s) from a unique-keyed "
                             "right table -> .npz")
    jo.add_argument("left", nargs="+",
                    help="left table file(s) (several scan as one dataset)")
    jo.add_argument("right")
    jo.add_argument("output")
    jo.add_argument("--on", required=True, metavar="KEY_COLUMN")
    jo.add_argument("--columns", default=None,
                    help="left projection (default: all left columns)")
    jo.add_argument("--right-columns", default=None,
                    help="right projection (default: all but the key)")
    jo.add_argument("--where", action="append", metavar="COLUMN:OP:VALUE",
                    help="left-side predicates (repeatable)")
    jo.add_argument("--how", default="inner", choices=["inner", "left"])
    jo.add_argument("--limit", type=int, default=None)
    jo.set_defaults(fn=_cmd_join)

    im = sub.add_parser("import",
                        help="compress a .parquet/.csv file to an .flt table")
    im.add_argument("input")
    im.add_argument("output")
    im.add_argument("--codec", default="auto",
                    choices=["auto", "bitpack", "ffor", "delta", "zdelta",
                             "rle", "dict"])
    im.add_argument("--chunk-blocks", type=int, default=1024)
    im.add_argument("--batch-rows", type=int, default=0,
                    help="stream the parquet file through TableWriter in "
                         "batches of this many rows (constant memory)")
    im.set_defaults(fn=_cmd_import)

    ex = sub.add_parser("export", help="decode an .flt table to .parquet")
    ex.add_argument("input")
    ex.add_argument("output")
    ex.set_defaults(fn=_cmd_export)

    b = sub.add_parser("bench",
                       help="single-block (1024-value) host latency micro-bench")
    b.add_argument("--dtype", default="u16", choices=list(layout.DTYPES))
    b.add_argument("--width", type=int, default=3)
    b.add_argument("--repeat", type=int, default=200)
    b.set_defaults(fn=_cmd_bench)
    return p


def main(argv=None) -> int:
    # Device-path subcommands (scan, decompress --device) run on the
    # platform JAX picks (JAX_PLATFORMS selects one explicitly).
    from .utils import runtime

    runtime.configure_compile_cache()
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, IndexError, KeyError, OSError) as e:
        msg = e.args[0] if isinstance(e, KeyError) and e.args else e
        print(f"error: {msg}", file=sys.stderr)
        return 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
