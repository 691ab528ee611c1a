"""Star Schema Benchmark data and its 13 queries in the contest's query
language.

Source: P. O'Neil, E. O'Neil, X. Chen, S. Revilak, "The Star Schema
Benchmark and Augmented Fact Table Indexing", TPCTC 2009; value rules of
its dbgen, which derives from TPC-H's (prices, order dates, customer
keys). The configuration file names the scale and the columns kept.

Relations, in catalog order (relation ids of the query text), with
every column of SSB's schema in its order (COLUMNS): 0 lineorder (17),
1 date (17), 2 customer (8), 3 supplier (7), 4 part (9).

Strings are dense integer codes that keep SSB's order where a query
compares them: region 0-4, nation 0-24 (TPC-H's, five to a region), city
nation * 10 + digit ('UNITED KI1' is nation 23's digit 1), p_mfgr 1-5
('MFGR#1'), p_category mfgr * 10 + 1-5 ('MFGR#12' is 12), p_brand1
category * 100 + 1-40 ('MFGR#2221' is 2221), d_yearmonth as
d_yearmonthnum ('Dec1997' is 199712). Names, addresses and phones are
distinct codes, the other strings codes of their value lists.

Each query template draws SSB's parameters from a numpy Generator within
the ranges that keep the published selectivity, and returns its lines in
the contest's `tables|predicates|projections` form (strict <, >, =):
GROUP BY and ORDER BY dropped, a product or difference summed as its
columns, a range of codes for a disjunction of adjacent codes, and the
cross product of disjoint sub-queries otherwise (their sums add).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

LINEORDER, DATE, CUSTOMER, SUPPLIER, PART = range(5)
COLUMNS = {
    "lineorder": ["lo_orderkey", "lo_linenumber", "lo_custkey",
                  "lo_partkey", "lo_suppkey", "lo_orderdate",
                  "lo_orderpriority", "lo_shippriority", "lo_quantity",
                  "lo_extendedprice", "lo_ordtotalprice", "lo_discount",
                  "lo_revenue", "lo_supplycost", "lo_tax", "lo_commitdate",
                  "lo_shipmode"],
    "date": ["d_datekey", "d_date", "d_dayofweek", "d_month", "d_year",
             "d_yearmonthnum", "d_yearmonth", "d_daynuminweek",
             "d_daynuminmonth", "d_daynuminyear", "d_monthnuminyear",
             "d_weeknuminyear", "d_sellingseason", "d_lastdayinweekfl",
             "d_lastdayinmonthfl", "d_holidayfl", "d_weekdayfl"],
    "customer": ["c_custkey", "c_name", "c_address", "c_city", "c_nation",
                 "c_region", "c_phone", "c_mktsegment"],
    "supplier": ["s_suppkey", "s_name", "s_address", "s_city", "s_nation",
                 "s_region", "s_phone"],
    "part": ["p_partkey", "p_name", "p_mfgr", "p_category", "p_brand1",
             "p_color", "p_type", "p_size", "p_container"],
}

# TPC-H's nations in key order and their regions (AFRICA, AMERICA, ASIA,
# EUROPE, MIDDLE EAST = 0-4)
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1]
FIRST_DAY, LAST_DAY = "1992-01-01", "1998-12-31"    # 2556 days, end excluded
LAST_ORDER_DAY = "1998-08-02"                        # ENDDATE - 151 days
CUST_MORTALITY = 3       # dbgen: no order names a customer key divisible by 3
N_COLORS, N_TYPES, N_CONTAINERS = 92, 150, 40
# holidays of dbgen's date table (month, day)
HOLIDAYS = [(1, 1), (7, 4), (11, 25), (12, 24), (12, 25), (12, 31)]


def ref(slot: int, table: str, column: str) -> str:
    """`slot.column` in the query language."""
    return f"{slot}.{COLUMNS[table].index(column)}"


def retail_price(partkey: torch.Tensor) -> torch.Tensor:
    """dbgen's p_retailprice in cents."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def date_columns() -> List[np.ndarray]:
    """The date dimension: one row a day, in date order, strings as the
    codes of the module's doc."""
    days = np.arange(FIRST_DAY, LAST_DAY, dtype="datetime64[D]")
    i = np.arange(len(days))
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dom = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    doy = (days - days.astype("datetime64[Y]")).astype(np.int64) + 1
    dow = (days.astype(np.int64) + 3) % 7 + 1          # Monday = 1
    ym = year * 100 + month
    next_month = (days + 1).astype("datetime64[M]").astype(np.int64) % 12 + 1
    season = np.select([(month == 12) & (dom >= 15), month >= 9, month >= 6,
                        month >= 3], [4, 3, 2, 1], 0)
    holiday = np.zeros(len(days), bool)
    for m, d in HOLIDAYS:
        holiday |= (month == m) & (dom == d)
    cols = [year * 10000 + month * 100 + dom, i, dow, month, year, ym, ym,
            dow, dom, doy, month, (doy - 1) // 7 + 1, season, dow == 7,
            next_month != month, holiday, dow <= 5]
    return [np.asarray(c).astype(np.uint64) for c in cols]


def _randint(gen, lo, hi, n, device):
    return torch.randint(lo, hi, (n,), generator=gen, device=device)


def _geo(gen: torch.Generator, n: int, device) -> List[torch.Tensor]:
    """key, name, address, city, nation, region, phone of a customer or
    supplier dimension (name and address codes: the key and a draw of
    distinct codes; the phone leads with the nation, as dbgen's)."""
    key = torch.arange(1, n + 1, device=device)
    address = torch.randperm(n, generator=gen, device=device)
    nation = _randint(gen, 0, 25, n, device)
    city = nation * 10 + _randint(gen, 0, 10, n, device)
    region = torch.tensor(NATION_REGION, device=device)[nation]
    phone = nation * n + torch.randperm(n, generator=gen, device=device)
    return [key, key, address, city, nation, region, phone]


def _to_host(cols: List[torch.Tensor]) -> List[np.ndarray]:
    return [c.to(torch.int64).cpu().numpy().view(np.uint64) for c in cols]


def _lineorder(gen, rows: Dict[str, int], datekeys: torch.Tensor, device
               ) -> List[torch.Tensor]:
    """lineorder's columns: orders of 1-7 lines until `rows` lines (the
    last order cut short), order-level values repeated on their lines."""
    n = rows["lineorder"]
    lines = _randint(gen, 1, 8, n // 2 + 64, device)      # > n lines
    ends = torch.cumsum(lines, 0)
    n_orders = int(torch.searchsorted(ends, torch.tensor(n, device=device)))
    n_orders += 1
    order = torch.repeat_interleave(torch.arange(n_orders, device=device),
                                    lines[:n_orders])[:n]
    linenumber = (torch.arange(n, device=device) - (ends - lines)[order]) + 1
    del lines, ends

    n_cust = rows["customer"]
    # a key among the customers not divisible by 3: the j-th is j + j//2 + 1
    j = _randint(gen, 0, n_cust - n_cust // CUST_MORTALITY, n_orders, device)
    custkey = (j + j // 2 + 1)[order]
    last = int((np.datetime64(LAST_ORDER_DAY) - np.datetime64(FIRST_DAY))
               .astype(np.int64))
    day = _randint(gen, 0, last + 1, n_orders, device)
    orderdate = datekeys[day][order]
    priority = _randint(gen, 1, 6, n_orders, device)[order]
    commitdate = datekeys[day[order] + _randint(gen, 30, 91, n, device)]
    del day, j
    partkey = _randint(gen, 1, rows["part"] + 1, n, device)
    suppkey = _randint(gen, 1, rows["supplier"] + 1, n, device)
    quantity = _randint(gen, 1, 51, n, device)
    discount = _randint(gen, 0, 11, n, device)
    tax = _randint(gen, 0, 9, n, device)
    price = retail_price(partkey)
    extprice = quantity * price
    revenue = extprice * (100 - discount) // 100
    supplycost = 6 * price // 10
    del price
    total = torch.zeros(n_orders, dtype=torch.int64, device=device)
    total.index_add_(0, order, revenue * (100 + tax) // 100)
    ordtotal = total[order]
    del total
    shipmode = _randint(gen, 0, 7, n, device)
    return [order + 1, linenumber, custkey, partkey, suppkey, orderdate,
            priority, torch.zeros_like(order), quantity, extprice, ordtotal,
            discount, revenue, supplycost, tax, commitdate, shipmode]


def generate(config: dict, seed: int, device) -> List[List[np.ndarray]]:
    """The five relations' columns (host uint64 arrays) from `seed`, drawn
    on `device` by one torch.Generator, at the row counts of `config`."""
    rows = config["rows"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dates = date_columns()
    n_parts = rows["part"]
    mfgr = _randint(gen, 1, 6, n_parts, device)
    cat = mfgr * 10 + _randint(gen, 1, 6, n_parts, device)
    color = _randint(gen, 0, N_COLORS, n_parts, device)
    part = [torch.arange(1, n_parts + 1, device=device),
            color * N_COLORS + _randint(gen, 0, N_COLORS, n_parts, device),
            mfgr, cat, cat * 100 + _randint(gen, 1, 41, n_parts, device),
            color, _randint(gen, 0, N_TYPES, n_parts, device),
            _randint(gen, 1, 51, n_parts, device),
            _randint(gen, 0, N_CONTAINERS, n_parts, device)]
    customer = _geo(gen, rows["customer"], device)
    customer.append(_randint(gen, 0, 5, rows["customer"], device))
    supplier = _geo(gen, rows["supplier"], device)
    datekeys = torch.from_numpy(dates[0].astype(np.int64)).to(device)
    fact = _to_host(_lineorder(gen, rows, datekeys, device))
    return [fact, dates, _to_host(customer), _to_host(supplier),
            _to_host(part)]


# ---- the 13 queries ----

def _line(slots, preds, projs) -> str:
    return (f"{' '.join(map(str, slots))}|{'&'.join(preds)}|"
            f"{' '.join(projs)}")


def _between(col: str, lo: int, hi: int) -> List[str]:
    """lo <= col <= hi in strict comparisons."""
    return [f"{col}>{lo - 1}", f"{col}<{hi + 1}"]


def _lo(name: str) -> str:
    return ref(0, "lineorder", name)


def _joins(slots) -> List[str]:
    """The fact's foreign key = each dimension's key, in slot order."""
    fk = {DATE: ("lo_orderdate", "date", "d_datekey"),
          CUSTOMER: ("lo_custkey", "customer", "c_custkey"),
          SUPPLIER: ("lo_suppkey", "supplier", "s_suppkey"),
          PART: ("lo_partkey", "part", "p_partkey")}
    out = []
    for s, rel in enumerate(slots[1:], 1):
        col, table, key = fk[rel]
        out.append(f"{_lo(col)}={ref(s, table, key)}")
    return out


def _year(rng) -> int:
    return int(rng.integers(1992, 1998))


def _category(rng) -> int:
    return int(rng.integers(1, 6)) * 10 + int(rng.integers(1, 6))


# flight 1: lineorder, date
_F1 = [LINEORDER, DATE]
_F1_PROJ = [_lo("lo_extendedprice"), _lo("lo_discount")]


def _flight1(rng, date_preds, quantity) -> List[str]:
    """lo_discount in [d, d+2] and the quantity predicates; SUM(
    lo_extendedprice * lo_discount) as the two SUMs."""
    d = int(rng.integers(1, 9))
    return [_line(_F1, _joins(_F1) + date_preds
                  + _between(_lo("lo_discount"), d, d + 2) + quantity,
                  _F1_PROJ)]


def _quantity_window(rng) -> List[str]:
    q = int(rng.integers(1, 42))
    return _between(_lo("lo_quantity"), q, q + 9)


def q1_1(rng) -> List[str]:
    """d_year; lo_quantity < 25."""
    return _flight1(rng, [f"{ref(1, 'date', 'd_year')}={_year(rng)}"],
                    [f"{_lo('lo_quantity')}<25"])


def q1_2(rng) -> List[str]:
    """d_yearmonthnum; lo_quantity in [q, q+9]."""
    ym = _year(rng) * 100 + int(rng.integers(1, 13))
    return _flight1(rng, [f"{ref(1, 'date', 'd_yearmonthnum')}={ym}"],
                    _quantity_window(rng))


def q1_3(rng) -> List[str]:
    """d_weeknuminyear and d_year; lo_quantity in [q, q+9]."""
    preds = [f"{ref(1, 'date', 'd_weeknuminyear')}={int(rng.integers(1, 53))}",
             f"{ref(1, 'date', 'd_year')}={_year(rng)}"]
    return _flight1(rng, preds, _quantity_window(rng))


# flight 2: lineorder, date, part, supplier; SUM(lo_revenue)
_F2 = [LINEORDER, DATE, PART, SUPPLIER]


def _flight2(rng, part_preds) -> List[str]:
    region = f"{ref(3, 'supplier', 's_region')}={int(rng.integers(0, 5))}"
    return [_line(_F2, _joins(_F2) + part_preds + [region],
                  [_lo("lo_revenue")])]


def q2_1(rng) -> List[str]:
    """p_category; s_region."""
    return _flight2(rng, [f"{ref(2, 'part', 'p_category')}={_category(rng)}"])


def q2_2(rng) -> List[str]:
    """p_brand1 in eight consecutive brands of a category; s_region."""
    b = _category(rng) * 100 + int(rng.integers(1, 34))
    return _flight2(rng, _between(ref(2, "part", "p_brand1"), b, b + 7))


def q2_3(rng) -> List[str]:
    """one p_brand1; s_region."""
    b = _category(rng) * 100 + int(rng.integers(1, 41))
    return _flight2(rng, [f"{ref(2, 'part', 'p_brand1')}={b}"])


# flight 3: customer, lineorder, supplier, date (fact first); SUM(lo_revenue)
_F3 = [LINEORDER, CUSTOMER, SUPPLIER, DATE]
_F3_YEARS = _between(ref(3, "date", "d_year"), 1992, 1997)


def _flight3(c_pred, s_pred, date_preds) -> str:
    return _line(_F3, _joins(_F3) + [f"{ref(1, 'customer', c_pred[0])}="
                                     f"{c_pred[1]}",
                                     f"{ref(2, 'supplier', s_pred[0])}="
                                     f"{s_pred[1]}"] + date_preds,
                 [_lo("lo_revenue")])


def q3_1(rng) -> List[str]:
    """c_region = s_region = r; d_year in [1992, 1997]."""
    r = int(rng.integers(0, 5))
    return [_flight3(("c_region", r), ("s_region", r), _F3_YEARS)]


def q3_2(rng) -> List[str]:
    """c_nation = s_nation; d_year in [1992, 1997]."""
    n = int(rng.integers(0, 25))
    return [_flight3(("c_nation", n), ("s_nation", n), _F3_YEARS)]


def _city_pairs(rng, date_preds) -> List[str]:
    """(c_city in two cities) and (s_city in the same two): two cities of
    one nation whose codes are never adjacent (SSB's KI1 and KI5), so four
    disjoint sub-queries."""
    nation = int(rng.integers(0, 25))
    a = int(rng.integers(0, 8))
    cities = [nation * 10 + a, nation * 10 + int(rng.integers(a + 2, 10))]
    return [_flight3(("c_city", c), ("s_city", s), date_preds)
            for c in cities for s in cities]


def q3_3(rng) -> List[str]:
    """two cities for customer and supplier; d_year in [1992, 1997]."""
    return _city_pairs(rng, _F3_YEARS)


def q3_4(rng) -> List[str]:
    """two cities; one d_yearmonth."""
    ym = _year(rng) * 100 + int(rng.integers(1, 13))
    return _city_pairs(rng, [f"{ref(3, 'date', 'd_yearmonth')}={ym}"])


# flight 4: date, customer, supplier, part (fact first);
# SUM(lo_revenue - lo_supplycost) as the two SUMs
_F4 = [LINEORDER, DATE, CUSTOMER, SUPPLIER, PART]
_F4_PROJ = [_lo("lo_revenue"), _lo("lo_supplycost")]


def _flight4(preds) -> List[str]:
    return [_line(_F4, _joins(_F4) + preds, _F4_PROJ)]


# Q4.2 and Q4.3's years as SSB publishes them: a drawn pair that left out
# 1998 (seven months of orders) would scan more rows, so the seed would
# change the work and not only its order
_F4_YEARS = _between(ref(1, "date", "d_year"), 1997, 1998)


def _regions(r) -> List[str]:
    return [f"{ref(2, 'customer', 'c_region')}={r}",
            f"{ref(3, 'supplier', 's_region')}={r}"]


def _mfgr2(rng) -> List[str]:
    m = int(rng.integers(1, 5))
    return _between(ref(4, "part", "p_mfgr"), m, m + 1)


def q4_1(rng) -> List[str]:
    """c_region = s_region = r; p_mfgr in two adjacent codes."""
    return _flight4(_regions(int(rng.integers(0, 5))) + _mfgr2(rng))


def q4_2(rng) -> List[str]:
    """q4.1 with d_year 1997 or 1998."""
    return _flight4(_F4_YEARS + _regions(int(rng.integers(0, 5)))
                    + _mfgr2(rng))


def q4_3(rng) -> List[str]:
    """d_year 1997 or 1998; c_region; s_nation in that region; one
    p_category."""
    r = int(rng.integers(0, 5))
    nations = [n for n, reg in enumerate(NATION_REGION) if reg == r]
    n = nations[int(rng.integers(0, len(nations)))]
    return _flight4(_F4_YEARS + [
        f"{ref(2, 'customer', 'c_region')}={r}",
        f"{ref(3, 'supplier', 's_nation')}={n}",
        f"{ref(4, 'part', 'p_category')}={_category(rng)}"])


TEMPLATES: Dict[str, object] = {
    "q1.1": q1_1, "q1.2": q1_2, "q1.3": q1_3,
    "q2.1": q2_1, "q2.2": q2_2, "q2.3": q2_3,
    "q3.1": q3_1, "q3.2": q3_2, "q3.3": q3_3, "q3.4": q3_4,
    "q4.1": q4_1, "q4.2": q4_2, "q4.3": q4_3,
}


def templates(config: dict, relations) -> Dict[str, object]:
    """Template name -> fn(rng) -> lines; SSB's parameters need no data."""
    return TEMPLATES
