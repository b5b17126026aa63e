#!/usr/bin/env python
"""Tour of the SQL-ish query surface over compressed FLT tables.

Covers the full column model — ints, floats, strings (sorted-dictionary),
bools, timestamps, NULLS — written by the streaming TableWriter across a
sharded 3-file dataset, then queried without ever materializing the
decoded columns: scans, WHERE pushdown (single / multi predicate /
string probes), GROUP BY, distinct / value_counts / top_k, and
SELECT ... WHERE ... ORDER BY ... LIMIT.

Run: python examples/query_tour.py [rows_per_shard]
"""

import sys
import tempfile

import numpy as np

sys.path.insert(0, ".")

from fastlanes_tpu import analytics, fio_table


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    rng = np.random.default_rng(0)
    cats = np.array(["EUR", "GBP", "JPY", "USD"])

    tmp = tempfile.mkdtemp()
    paths, all_qty, all_cur, all_price = [], [], [], []
    for shard in range(3):
        qty = rng.integers(0, 1000, n).astype(np.uint32)
        cur = cats[rng.integers(0, 4, n)]
        price = np.round(rng.normal(100.0, 15.0, n), 2)
        pmask = rng.random(n) < 0.05  # 5% missing prices
        ts = (np.datetime64("2026-08-18", "ns")
              + np.sort(rng.integers(0, 86_400_000, n))
              .astype("timedelta64[ms]").astype("timedelta64[ns]"))
        path = f"{tmp}/shard{shard}.flt"
        # streaming writer: batches spill chunk-by-chunk (O(chunk) memory)
        with fio_table.TableWriter(path) as w:
            for at in range(0, n, 16_384):
                sl = slice(at, at + 16_384)
                w.append({"qty": qty[sl], "cur": cur[sl],
                          "price": np.ma.MaskedArray(price, mask=pmask)[sl],
                          "ts": ts[sl], "paid": (qty[sl] > 0)})
        paths.append(path)
        all_qty.append(qty)
        all_cur.append(cur)
        all_price.append(np.ma.MaskedArray(price, mask=pmask))
    qty = np.concatenate(all_qty)
    cur = np.concatenate(all_cur)
    price = np.ma.concatenate(all_price)

    # 1) dataset scan: one shared accumulator across shards (exact sums)
    s = analytics.scan_table(paths)
    assert s["qty"]["sum"] == int(qty.sum())
    assert s["price"]["n_null"] == int(np.ma.getmaskarray(price).sum())
    print(f"scan_table over {len(paths)} shards x {n} rows: "
          f"qty sum={s['qty']['sum']}, price nulls={s['price']['n_null']}")

    # 2) WHERE pushdown, string probe translated to dictionary codes
    eur = analytics.scan_where(paths, "eq", "EUR", column="qty", where="cur")
    mask = cur == "EUR"
    assert eur["sum"] == int(qty[mask].sum())
    print(f"WHERE cur = 'EUR': {eur['count']} rows, qty sum {eur['sum']}")

    # 3) multi-predicate WHERE
    hot = analytics.scan_where_multi(
        paths, [("cur", "ne", "JPY"), ("qty", "gt", 900)], column="qty")
    m2 = (cur != "JPY") & (qty > 900)
    assert hot["count"] == int(m2.sum())
    print(f"WHERE cur != 'JPY' AND qty > 900: {hot['count']} rows")

    # 4) GROUP BY a string key (device scatter-reduce per shard)
    per_cur = analytics.group_stats(paths, "cur", "qty")
    assert per_cur["USD"]["sum"] == int(qty[cur == "USD"].sum())
    print("GROUP BY cur:", {g: r["sum"] for g, r in sorted(per_cur.items())})

    # 4b) GROUP BY ... WHERE: predicates filter rows before grouping
    big = analytics.group_stats(paths, "cur", "qty",
                                preds=[("qty", "gt", 900)])
    mb = qty > 900
    assert big["USD"]["count"] == int((mb & (cur == "USD")).sum())
    print("GROUP BY cur WHERE qty>900:",
          {g: r["count"] for g, r in sorted(big.items())})

    # 5) distinct / value_counts / top_k
    assert list(analytics.distinct(paths, "cur")) == sorted(set(cur))
    vc = analytics.value_counts(paths, "cur")
    assert vc["GBP"] == int((cur == "GBP").sum())
    top = analytics.top_k(paths, "price", k=3)
    print(f"value_counts(cur)={vc}; top-3 prices={top}")

    # 6) SELECT ... WHERE ... ORDER BY ... LIMIT (per-shard device top-k)
    rows = analytics.select(paths, columns=["qty", "cur", "price"],
                            preds=[("cur", "eq", "GBP")],
                            order_by="price", desc=True, limit=5)
    sel = np.ma.getmaskarray(price) == False  # noqa: E712 - mask array
    m3 = (cur == "GBP") & sel
    want = np.sort(np.ma.getdata(price)[m3])[::-1][:5]
    got = np.asarray(np.ma.getdata(rows["price"]))
    assert np.allclose(got, want)
    print("SELECT qty,cur,price WHERE cur='GBP' ORDER BY price DESC LIMIT 5:")
    for q, c, p in zip(rows["qty"], rows["cur"], got):
        print(f"  qty={int(q):4d} cur={c} price={p:.2f}")


if __name__ == "__main__":
    main()
