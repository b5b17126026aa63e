#!/usr/bin/env python
"""Analytics over a compressed table file, decoded and aggregated on-chip.

The full production pipeline: a multi-column FLTTAB file on disk -> only
the compressed bytes cross host memory/PCIe -> the accelerator decodes and
aggregates in one fused graph. Query: total quantity and order count for
one customer, over columns stored at ~4-7 bits/value.

Run: python examples/table_analytics.py [n_rows]
"""

import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from fastlanes_tpu import fio, fio_device, fio_table
from fastlanes_tpu.core import layout
from fastlanes_tpu.kernels import codecs as pk
from fastlanes_tpu.ops import transpose as tr


def load_column_chunks(path, name):
    """Ship one column's compressed chunks to the device. Returns
    (static_metas, arrays): arrays are jit-argument pytrees (so the decode
    is NOT baked into the executable as constants), metas are the static
    (codec, width, dtype) config the decode function closes over."""
    header = fio_table.read_table_header(path)
    col = header["columns"][name]
    base_off = fio.payload_base_of(path, fio_table.MAGIC)
    dtype = col["dtype"]
    np_dt = layout.np_dtype(dtype)
    nl = layout.lanes(dtype)
    metas, arrays = [], []
    with open(path, "rb") as f:
        for meta in col["chunks"]:
            f.seek(base_off + meta["offset"])
            raw = f.read(meta["nbytes"])
            nb = meta["n_blocks"]
            if meta["codec"] in ("delta", "zdelta"):
                bb = nb * nl * np_dt.itemsize
                arrays.append({
                    "base": jnp.asarray(np.frombuffer(raw[:bb], np_dt).reshape(nb, nl)),
                    "packed": jnp.asarray(np.frombuffer(raw[bb:], np_dt).reshape(nb, -1)),
                })
            else:
                arrays.append({"packed": jnp.asarray(
                    np.frombuffer(raw, np_dt).reshape(nb, -1))})
            metas.append({"codec": meta["codec"], "width": meta["width"],
                          "dtype": dtype,
                          "reference": meta.get("reference")})
    return metas, arrays


def decode_chunk(meta, arrs):
    """Decode one chunk inside a jit graph (arrays are traced arguments)."""
    codec, w, dt = meta["codec"], meta["width"], meta["dtype"]
    if codec == "zdelta":
        return tr.untranspose(pk.unzdelta_pack(arrs["packed"], arrs["base"], w, dt), dt)
    if codec == "delta":
        return tr.untranspose(pk.undelta_pack(arrs["packed"], arrs["base"], w, dt), dt)
    if codec == "ffor":
        return pk.unfor_pack(arrs["packed"], meta["reference"], w, dt)
    return pk.unpack(arrs["packed"], w, dt)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    rng = np.random.default_rng(0)
    customer = rng.integers(0, 10_000, n, np.int64).astype(np.uint32)
    qty = rng.integers(1, 30, n, np.int64).astype(np.uint32)
    target = 4242
    # pad rows count to full blocks so padded tail values (repeats of the
    # final customer id) can't alias the target
    assert customer[-1] != target

    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        fio_table.write_table(f.name, {"customer": customer, "qty": qty})
        import os
        raw_mb = (customer.nbytes + qty.nbytes) / 2**20
        file_mb = os.path.getsize(f.name) / 2**20
        # correctness: the library device reader (handles any transform)
        dev_customer = np.asarray(fio_device.read_column_device(f.name, "customer"))
        assert np.array_equal(dev_customer, customer)
        cmetas, carrs = load_column_chunks(f.name, "customer")
        qmetas, qarrs = load_column_chunks(f.name, "qty")

    @jax.jit
    def query(c_arrays, q_arrays):
        hits = jnp.uint32(0)
        total = jnp.uint32(0)
        for cm, ca, qm, qa in zip(cmetas, c_arrays, qmetas, q_arrays):
            c = decode_chunk(cm, ca).reshape(-1)
            q = decode_chunk(qm, qa).reshape(-1)
            m = (c == jnp.uint32(target)).astype(jnp.uint32)
            hits += jnp.sum(m, dtype=jnp.uint32)
            total += jnp.sum(m * q, dtype=jnp.uint32)
        return hits, total

    hits, total = jax.device_get(query(carrs, qarrs))  # compile + run
    mask = customer == target
    assert int(hits) == int(mask.sum()), (int(hits), int(mask.sum()))
    assert int(total) == int(qty[mask].sum())
    t0 = time.perf_counter()
    _ = jax.device_get(query(carrs, qarrs))
    dt = time.perf_counter() - t0
    print(f"{n} rows, {raw_mb:.1f} MiB raw -> {file_mb:.1f} MiB on disk "
          f"({raw_mb/file_mb:.1f}x)")
    print(f"customer {target}: {int(hits)} orders, {int(total)} total qty "
          f"(on-chip result, verified vs numpy)")
    print(f"on-chip decode+filter+aggregate: {dt*1e3:.1f} ms = "
          f"{n/dt/1e6:.0f}M rows/s x 2 columns")

    # The library spellings of the same query (analytics module): filtered
    # aggregation and GROUP BY run the identical fused decode->reduce
    # pipeline without the hand-rolled plumbing above.
    from fastlanes_tpu import analytics

    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        tier = (customer % 5).astype(np.uint16)
        cats = np.array(["EUR", "GBP", "JPY", "USD"])
        currency = cats[customer % 4]  # STRING column: dictionary-encoded
        fio_table.write_table(f.name, {"customer": customer, "qty": qty,
                                       "tier": tier, "currency": currency})
        s = analytics.scan_where(f.name, "eq", target,
                                 column="qty", where="customer")
        assert s["count"] == int(mask.sum())
        assert s["sum"] == int(qty[mask].sum())
        per_tier = analytics.group_stats(f.name, "tier", "qty")
        assert per_tier[0]["sum"] == int(qty[tier == 0].sum())
        print(f"analytics.scan_where one-liner agrees: {s}")
        print(f"analytics.group_stats('tier', 'qty'): "
              f"{ {g: r['sum'] for g, r in sorted(per_tier.items())} }")
        # string predicates and group-bys run as integer code compares
        # (sorted dictionary: code order == lexicographic order)
        eur = analytics.scan_where(f.name, "eq", "EUR",
                                   column="qty", where="currency")
        assert eur["sum"] == int(qty[currency == "EUR"].sum())
        per_cur = analytics.group_stats(f.name, "currency", "qty")
        assert set(per_cur) == set(cats)
        print(f"analytics.group_stats('currency', 'qty') [string key]: "
              f"{ {g: r['sum'] for g, r in sorted(per_cur.items())} }")


if __name__ == "__main__":
    main()
