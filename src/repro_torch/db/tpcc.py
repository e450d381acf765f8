"""TPC-C workload (§7.1.1): the full five-transaction mix.

The paper runs only NewOrder + Payment (88% of the standard mix) because the
other three need range scans its system does not support; this repro's
storage subsystem (ordered secondary indexes + range-scan OCC,
``repro_torch.storage``) lifts that limitation.  ``mix="standard2"`` reproduces the
paper's 2-transaction workload bit-for-bit; ``mix="full"`` runs the standard
45/43/4/4/4 NewOrder/Payment/OrderStatus/Delivery/StockLevel mix:

* OrderStatus — reads the customer's most recent order via a range scan of
  the ``orders_by_cust`` index (phantom-protected) + order/order-line reads;
* Delivery — consumes the OLDEST undelivered NEW-ORDER per district via a
  ``SCAN_CONSUME`` range scan of the ``neworder`` index (min-key within the
  district's key range; the host's optimistic prediction is validated
  on-device and a mismatch aborts the transaction), then carrier/balance
  updates;
* StockLevel — scans the ``orders_by_id`` index for the district's most
  recent orders and reads their order lines + stock rows (scaled down from
  the spec's 20 orders to what fits the fixed op budget — see DESIGN.md).

Host-side sequencer state (``TPCCState``) mirrors order ids, undelivered
queues, per-customer last orders and retained-order contents, so stored-
procedure parameters (rows, scan ranges, expected keys) are computable at
generation time; the device validates every prediction through the index.

Partitioned by warehouse: one partition == one warehouse, all 9 tables hashed
by warehouse id; ITEM is read-only and replicated per partition (the paper
replicates read-only data everywhere and never ships it).  Rows are int32
word-packed; the *byte* accounting (Fig. 15) uses the true TPC-C row sizes.

Default mix: alternating NewOrder/Payment; 10% of NewOrder and 15% of Payment
are cross-partition (§7.1.1).  1% of NewOrder aborts (invalid item id).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.ops import (ADD, APPEND, DELETE_IDX, IDX_OPS, INSERT_IDX,
                            IX_EXPECT, IX_HI, IX_ID, IX_KEY, PAY_CUST, READ,
                            SCAN_CONSUME, SCAN_READ, SET, STOCK_DECR)
from repro_torch.storage.index import IndexSpec

C = 10
M = 64                 # ops per txn (NewOrder worst case + index ops)
N_DIST = 10

# ordered secondary indexes (mix="full"); local-key layouts (24 bits):
#   neworder / orders_by_id:  d * 2^20 | o_id          (o_id < 2^20)
#   orders_by_cust:           d * 2^20 | c_id * 2^8 | o_id % order_ring
# the partition (warehouse) id fills the high bits (storage.index.full_key)
NO_IDX, OID_IDX, CUST_IDX = 0, 1, 2

# txn_type codes: 0 NewOrder, 1 Payment, 2 OrderStatus, 3 Delivery,
# 4 StockLevel — OrderStatus and StockLevel are pure READ/SCAN_READ
# profiles the read tier can serve from replica snapshots
READ_ONLY_TYPES = (2, 4)
D_SHIFT, C_SHIFT = 20, 8

# true TPC-C row byte sizes (for replication accounting)
ROW_BYTES = {"warehouse": 89, "district": 95, "customer": 655, "stock": 306,
             "item": 82, "orders": 24, "new_order": 8, "order_line": 54,
             "index": 16}
# operation-replication operand sizes
OP_BYTES = {READ: 0, SET: 24, ADD: 16, APPEND: 24, STOCK_DECR: 16,
            PAY_CUST: 28, SCAN_READ: 0, SCAN_CONSUME: 16, INSERT_IDX: 12,
            DELETE_IDX: 8}

# customer row layout: [data_hash, data_len, balance, ytd_paid, pay_cnt,
# discount] — c_data words first so the fused PAY_CUST op owns cols 0-1.
# orders row: [c_id, o_id, ol_cnt, all_local, carrier_id]
# order_line row (mix="full"): [item, qty, amount, o_id]


@dataclass(frozen=True)
class TPCCConfig:
    n_partitions: int
    n_items: int = 100_000
    cust_per_district: int = 3_000
    order_ring: int = 1_024            # retained orders per district
    neworder_cross: float = 0.10
    payment_cross: float = 0.15
    neworder_abort: float = 0.01
    mix: str = "standard2"             # "standard2" | "full" (45/43/4/4/4)
    # Delivery only consumes a cross-partition-origin order once this many
    # transactions have been generated since it: cross NewOrders commit in
    # the *single-master* phase (after the partitioned phase that would run
    # the Delivery), so a too-fresh prediction would be validated against an
    # index the insert has not reached yet and the district would be skipped.
    delivery_gen_lag: int = 512
    seed: int = 0

    # ---- per-partition row layout --------------------------------------
    @property
    def off_warehouse(self):
        return 0

    @property
    def off_district(self):
        return 1

    @property
    def off_customer(self):
        return 1 + N_DIST

    @property
    def off_stock(self):
        return self.off_customer + N_DIST * self.cust_per_district

    @property
    def off_item(self):
        return self.off_stock + self.n_items

    @property
    def off_orders(self):
        return self.off_item + self.n_items

    @property
    def off_new_order(self):
        return self.off_orders + N_DIST * self.order_ring

    @property
    def off_order_line(self):
        return self.off_new_order + N_DIST * self.order_ring

    @property
    def rows_per_partition(self):
        return self.off_order_line + N_DIST * self.order_ring * 15

    @property
    def index_capacity(self):
        """Slots per partition per index: every retained order holds at most
        one entry in each index (eviction deletes ride the evicting
        NewOrder, and user-aborted NewOrders no longer draw an o_id, so
        they leak nothing).  The small headroom covers the one remaining
        leak source: a starved cross-partition NewOrder whose eviction
        delete never applied (offline only — the service re-queues starved
        lanes).  Was 2x before the abort-leak fix."""
        return N_DIST * self.order_ring \
            + max(N_DIST * self.order_ring // 8, 2 * N_DIST)


def index_specs(cfg: TPCCConfig) -> list[IndexSpec]:
    """The three ordered secondary indexes the full mix needs (pass to
    ``StarEngine(indexes=...)``); order must match NO_IDX/OID_IDX/CUST_IDX."""
    cap = cfg.index_capacity
    return [IndexSpec("neworder", cap), IndexSpec("orders_by_id", cap),
            IndexSpec("orders_by_cust", cap)]


def _key_no(w, d, o_id):
    return (w << 24) | (d << D_SHIFT) | o_id


def _key_cust(w, d, c_id, slot):
    return (w << 24) | (d << D_SHIFT) | (c_id << C_SHIFT) | slot


@dataclass
class TPCCState:
    """Host-side sequencer state: o_id assignment per (warehouse, district).
    Order-id draw is hoisted into the router (stored-procedure parameters),
    keeping insert rows unique across retries — noted in DESIGN.md.

    For ``mix="full"`` the state also mirrors what the stored procedures
    need as parameters: per-district undelivered-order queues (Delivery's
    oldest-first consume), each customer's last order id (OrderStatus), and
    the contents of retained orders (StockLevel's item/stock reads).  Every
    prediction derived from this mirror is validated on-device through the
    ordered indexes; a stale prediction skips that op group (counted in
    ``consume_skips``), it can never corrupt state."""
    cfg: TPCCConfig
    next_o_id: np.ndarray = None

    def __post_init__(self):
        cfg = self.cfg
        if self.next_o_id is None:
            self.next_o_id = np.full((cfg.n_partitions, N_DIST), 3001,
                                     np.int64)
        if cfg.mix == "full":
            assert cfg.order_ring <= (1 << C_SHIFT), \
                "mix='full' needs order_ring <= 256 (orders_by_cust key bits)"
            assert cfg.cust_per_district < (1 << (D_SHIFT - C_SHIFT)), \
                "mix='full' needs cust_per_district < 4096 (key bits)"
            P, ring = cfg.n_partitions, cfg.order_ring
            self.undelivered = [[[] for _ in range(N_DIST)] for _ in range(P)]
            self.last_o = np.full((P, N_DIST, cfg.cust_per_district), -1,
                                  np.int64)
            self.ring_cust = np.full((P, N_DIST, ring), -1, np.int32)
            self.ring_olcnt = np.zeros((P, N_DIST, ring), np.int32)
            self.ring_items = np.full((P, N_DIST, ring, 15), -1, np.int32)
            self.ring_qty = np.zeros((P, N_DIST, ring, 15), np.int32)
            self.i_price = None        # filled by init_values(..., state=...)
            self.txn_gen = 0           # generation counter (delivery gating)
            self.batch_floor = 0       # txn_gen at the current batch's start
            self.pushed_amount = 0     # ledger: Σ amounts of queued orders
            self.evicted_amount = 0    # ledger: Σ amounts evicted undelivered
            # Delivery's optimistic pops, keyed by the consume's EXPECT key —
            # resolved by apply_consume_feedback (delivered vs re-queued)
            self.pending_claims = {}


def init_values(cfg: TPCCConfig, rng: np.random.Generator,
                state: TPCCState | None = None):
    """Initial (P, R, C) int32 database content.  When ``state`` is given the
    drawn item prices are mirrored into it so the full-mix generator can
    compute order-line amounts host-side."""
    P, R = cfg.n_partitions, cfg.rows_per_partition
    val = np.zeros((P, R, C), np.int32)
    val[:, cfg.off_warehouse, 1] = rng.integers(0, 2000, P)            # w_tax
    d = np.arange(N_DIST)
    val[:, cfg.off_district + d, 0] = 3001                             # next_o_id
    val[:, cfg.off_district + d, 2] = rng.integers(0, 2000, (P, N_DIST))
    cust = slice(cfg.off_customer, cfg.off_customer + N_DIST * cfg.cust_per_district)
    val[:, cust, 5] = rng.integers(0, 5000, (P, N_DIST * cfg.cust_per_district))
    stock = slice(cfg.off_stock, cfg.off_stock + cfg.n_items)
    val[:, stock, 0] = rng.integers(10, 101, (P, cfg.n_items))         # s_qty
    item = slice(cfg.off_item, cfg.off_item + cfg.n_items)
    prices = rng.integers(100, 10000, (P, cfg.n_items))
    val[:, item, 0] = prices                                           # i_price
    if state is not None and cfg.mix == "full":
        state.i_price = prices.astype(np.int64)
    return val


def _new_order(cfg, state, rng, w):
    """Emit one NewOrder as (parts, rows, kinds, deltas, is_cross, abort)."""
    d_id = rng.integers(0, N_DIST)
    c_id = rng.integers(0, cfg.cust_per_district)
    ol_cnt = rng.integers(5, 16)
    is_cross = rng.random() < cfg.neworder_cross
    abort = rng.random() < cfg.neworder_abort
    o_id = state.next_o_id[w, d_id]
    state.next_o_id[w, d_id] += 1
    slot = int(o_id % cfg.order_ring)

    parts = np.full(M, w, np.int32)
    rows = np.zeros(M, np.int32)
    kinds = np.full(M, READ, np.int32)
    deltas = np.zeros((M, C), np.int32)
    tables = ["warehouse"] * M

    rows[0] = cfg.off_warehouse                                        # w tax
    rows[1] = cfg.off_district + d_id                                  # RMW next_o_id
    kinds[1] = ADD
    deltas[1, 0] = 1
    tables[1] = "district"
    rows[2] = cfg.off_customer + d_id * cfg.cust_per_district + c_id
    tables[2] = "customer"

    remote_items = set()
    if is_cross and cfg.n_partitions > 1:
        remote_items = set(rng.choice(ol_cnt, size=max(1, ol_cnt // 5),
                                      replace=False).tolist())
    for i in range(int(ol_cnt)):
        item = rng.integers(0, cfg.n_items)
        qty = rng.integers(1, 11)
        supply_w = w
        if i in remote_items:
            supply_w = int(rng.integers(0, cfg.n_partitions))
        j = 3 + 2 * i
        rows[j] = cfg.off_item + item                                  # price
        tables[j] = "item"
        rows[j + 1] = cfg.off_stock + item
        parts[j + 1] = supply_w
        kinds[j + 1] = STOCK_DECR
        deltas[j + 1, 0] = qty
        deltas[j + 1, 3] = int(supply_w != w)
        tables[j + 1] = "stock"

    base = 3 + 2 * 15
    rows[base] = cfg.off_orders + d_id * cfg.order_ring + slot         # order
    kinds[base] = SET
    deltas[base, :4] = (c_id, int(o_id), int(ol_cnt), int(not remote_items))
    tables[base] = "orders"
    rows[base + 1] = cfg.off_new_order + d_id * cfg.order_ring + slot
    kinds[base + 1] = SET
    deltas[base + 1, 0] = int(o_id)
    tables[base + 1] = "new_order"
    for i in range(int(ol_cnt)):
        r = base + 2 + i
        rows[r] = (cfg.off_order_line
                   + (d_id * cfg.order_ring + slot) * 15 + i)
        kinds[r] = SET
        deltas[r, 0] = 1
        tables[r] = "order_line"

    return parts, rows, kinds, deltas, bool(remote_items), abort, tables


def _payment(cfg, rng, w):
    d_id = rng.integers(0, N_DIST)
    c_id = rng.integers(0, cfg.cust_per_district)
    amount = int(rng.integers(100, 500000))
    is_cross = rng.random() < cfg.payment_cross and cfg.n_partitions > 1
    c_w = int(rng.integers(0, cfg.n_partitions)) if is_cross else w

    parts = np.full(M, w, np.int32)
    rows = np.zeros(M, np.int32)
    kinds = np.full(M, READ, np.int32)
    deltas = np.zeros((M, C), np.int32)
    tables = ["warehouse"] * M

    kinds[0] = ADD                                                     # w_ytd
    rows[0] = cfg.off_warehouse
    deltas[0, 0] = amount
    rows[1] = cfg.off_district + d_id
    kinds[1] = ADD                                                     # d_ytd
    deltas[1, 1] = amount
    tables[1] = "district"
    crow = cfg.off_customer + d_id * cfg.cust_per_district + c_id
    rows[2] = crow
    parts[2] = c_w
    kinds[2] = PAY_CUST       # fused: c_data concat + balance/ytd/cnt update
    deltas[2, 0] = amount & 0x7FFFFFFF
    deltas[2, 1] = 24
    deltas[2, 2] = -amount
    deltas[2, 3] = amount
    deltas[2, 4] = 1
    tables[2] = "customer"

    return parts, rows, kinds, deltas, (c_w != w), False, tables


# ---------------------------------------------------------------------------
# full mix (45/43/4/4/4): index-maintaining NewOrder + the three scan txns
# ---------------------------------------------------------------------------
def _blank(w):
    parts = np.full(M, w, np.int32)
    rows = np.zeros(M, np.int32)
    kinds = np.full(M, READ, np.int32)
    deltas = np.zeros((M, C), np.int32)
    tables = ["warehouse"] * M
    return parts, rows, kinds, deltas, tables


def _idx_op(kinds, deltas, tables, slot, kind, iid, key, hi_or_prow=0,
            expect=0):
    kinds[slot] = kind
    deltas[slot, IX_KEY] = key          # IX_LO aliases IX_KEY (col 0)
    deltas[slot, IX_HI] = hi_or_prow    # IX_PROW aliases IX_HI (col 1)
    deltas[slot, IX_EXPECT] = expect
    deltas[slot, IX_ID] = iid
    tables[slot] = "index"


def _new_order_full(cfg, state, rng, w):
    """NewOrder with index maintenance: inserts into all three indexes and
    evicts the retained order that its ring slot overwrites.

    A user-aborted NewOrder executes NOTHING on device — so it must not
    consume an o_id or carry index maintenance: its eviction DELETE_IDX ops
    would be dropped with it, leaking stale entries (the former DESIGN.md
    "known long-tail desync (a)").  The abort flag is drawn at generation
    time, so the draw is unwound right here and the next NewOrder of the
    district re-uses the o_id; the mirror, the device and the indexes all
    agree that the aborted order never existed."""
    parts, rows, kinds, deltas, is_cross, abort, tables = _new_order(
        cfg, state, rng, w)
    # _new_order laid primary ops into slots 0..49; shift them up by IDX_OPS
    # so index ops take the first IDX_OPS slots (executor convention)
    n_prim = M - IDX_OPS
    parts[IDX_OPS:] = parts[:n_prim].copy()
    rows[IDX_OPS:] = rows[:n_prim].copy()
    kinds[IDX_OPS:] = kinds[:n_prim].copy()
    deltas[IDX_OPS:] = deltas[:n_prim].copy()
    tables[IDX_OPS:] = list(tables[:n_prim])
    parts[:IDX_OPS] = w
    rows[:IDX_OPS] = 0
    kinds[:IDX_OPS] = READ
    deltas[:IDX_OPS] = 0
    tables[:IDX_OPS] = ["warehouse"] * IDX_OPS

    # recover this order's draw results from the shifted primary ops
    ring = cfg.order_ring
    d_id = int(rows[IDX_OPS + 1] - cfg.off_district)
    o_id = int(state.next_o_id[w, d_id]) - 1      # _new_order just drew it
    if abort:
        state.next_o_id[w, d_id] = o_id           # unwind the draw: the
        return parts, rows, kinds, deltas, is_cross, abort, tables  # aborted
        # order never existed — no index ops, no eviction, no mirror entry
    slot = o_id % ring
    c_id = int(rows[IDX_OPS + 2] - cfg.off_customer
               - d_id * cfg.cust_per_district)
    order_row = cfg.off_orders + d_id * ring + slot
    no_row = cfg.off_new_order + d_id * ring + slot

    # rich order lines: [item, qty, amount, o_id] + host mirror of contents
    items = np.full(15, -1, np.int64)
    qtys = np.zeros(15, np.int64)
    n_lines = 0
    amount = 0
    for i in range(15):
        j = IDX_OPS + 3 + 2 * i
        if kinds[j + 1] == STOCK_DECR:
            it = int(rows[j] - cfg.off_item)
            q = int(deltas[j + 1, 0])
            price = (int(state.i_price[w, it])
                     if state.i_price is not None else 1)
            r = IDX_OPS + 3 + 2 * 15 + 2 + n_lines
            deltas[r, :4] = (it, q, q * price, o_id % (1 << D_SHIFT))
            items[n_lines], qtys[n_lines] = it, q
            amount += q * price
            n_lines += 1

    o_lo = o_id % (1 << D_SHIFT)       # bounded key space (documented)
    _idx_op(kinds, deltas, tables, 0, INSERT_IDX, NO_IDX,
            _key_no(w, d_id, o_lo), hi_or_prow=no_row)
    _idx_op(kinds, deltas, tables, 1, INSERT_IDX, OID_IDX,
            _key_no(w, d_id, o_lo), hi_or_prow=order_row)
    _idx_op(kinds, deltas, tables, 2, INSERT_IDX, CUST_IDX,
            _key_cust(w, d_id, c_id, slot), hi_or_prow=order_row)
    evicted = o_id - ring
    if evicted >= 3001:
        ev_lo = evicted % (1 << D_SHIFT)
        _idx_op(kinds, deltas, tables, 3, DELETE_IDX, OID_IDX,
                _key_no(w, d_id, ev_lo))
        _idx_op(kinds, deltas, tables, 4, DELETE_IDX, NO_IDX,
                _key_no(w, d_id, ev_lo))
        ev_c = int(state.ring_cust[w, d_id, slot])
        if ev_c >= 0:   # deletes apply before inserts: same-key re-insert OK
            _idx_op(kinds, deltas, tables, 5, DELETE_IDX, CUST_IDX,
                    _key_cust(w, d_id, ev_c, slot))

    # host mirror follows the prediction (aborts returned early above)
    q = state.undelivered[w][d_id]
    if q and q[0][0] == evicted:        # evicting a still-undelivered order
        state.evicted_amount += q.pop(0)[2]
    state.undelivered[w][d_id].append(
        (o_id, c_id, amount, state.txn_gen, is_cross))
    state.pushed_amount += amount
    state.last_o[w, d_id, c_id] = o_id
    state.ring_cust[w, d_id, slot] = c_id
    state.ring_olcnt[w, d_id, slot] = n_lines
    state.ring_items[w, d_id, slot, :] = -1
    state.ring_items[w, d_id, slot, :n_lines] = items[:n_lines]
    state.ring_qty[w, d_id, slot, :n_lines] = qtys[:n_lines]
    return parts, rows, kinds, deltas, is_cross, abort, tables


def _order_status(cfg, state, rng, w):
    """Read-only: customer's most recent order via an orders_by_cust range
    scan (phantom-protected) + order/order-line point reads."""
    parts, rows, kinds, deltas, tables = _blank(w)
    d_id = int(rng.integers(0, N_DIST))
    c_id = int(rng.integers(0, cfg.cust_per_district))
    ring = cfg.order_ring
    _idx_op(kinds, deltas, tables, 0, SCAN_READ, CUST_IDX,
            _key_cust(w, d_id, c_id, 0), hi_or_prow=_key_cust(w, d_id, c_id + 1, 0))
    rows[IDX_OPS] = cfg.off_customer + d_id * cfg.cust_per_district + c_id
    tables[IDX_OPS] = "customer"
    o_last = int(state.last_o[w, d_id, c_id])
    if o_last >= 0 and o_last >= int(state.next_o_id[w, d_id]) - ring:
        slot = o_last % ring
        rows[IDX_OPS + 1] = cfg.off_orders + d_id * ring + slot
        tables[IDX_OPS + 1] = "orders"
        n = int(state.ring_olcnt[w, d_id, slot])
        for i in range(n):
            rows[IDX_OPS + 2 + i] = cfg.off_order_line \
                + (d_id * ring + slot) * 15 + i
            tables[IDX_OPS + 2 + i] = "order_line"
    return parts, rows, kinds, deltas, False, False, tables


def _delivery(cfg, state, rng, w):
    """Consume the oldest undelivered NEW-ORDER of every district via an
    index range scan (min key in the district's range, validated against the
    host prediction), stamp the carrier, credit the customer balance."""
    parts, rows, kinds, deltas, tables = _blank(w)
    carrier = int(rng.integers(1, 11))
    ring = cfg.order_ring
    j = IDX_OPS
    for d_id in range(N_DIST):
        q = state.undelivered[w][d_id]
        if not q:
            continue                       # spec: skip empty districts
        o_id, c_id, amount, gen, was_cross = q[0]
        if was_cross and (gen >= state.batch_floor
                          or state.txn_gen - gen < cfg.delivery_gen_lag):
            # a cross NewOrder commits in the single-master phase, AFTER the
            # partitioned phase that would run this Delivery: never consume a
            # cross-origin order from the same generation batch (offline
            # safety regardless of batch size), and in streaming mode also
            # wait delivery_gen_lag generations (chunks != epoch boundaries)
            continue
        entry = q.pop(0)                   # optimistic host-side claim
        o_lo = o_id % (1 << D_SHIFT)
        slot = o_id % ring
        # remember the claim: apply_consume_feedback re-queues it if the
        # on-device consume validation skips this district.  A key already
        # claimed means o_id wrapped mod 2^D_SHIFT past an unresolved claim
        # — that order is long ring-evicted; retire it, never overwrite
        # silently.  The dict stays bounded even when no feedback consumer
        # is wired: past a soft cap, stale (ring-evicted) claims retire.
        key = _key_no(w, d_id, o_lo)
        old = state.pending_claims.pop(key, None)
        if old is not None:
            state.evicted_amount += old[2][2]
        state.pending_claims[key] = (w, d_id, entry)
        if len(state.pending_claims) > 1024 + 32 * N_DIST * cfg.n_partitions:
            _prune_stale_claims(state)
        _idx_op(kinds, deltas, tables, d_id, SCAN_CONSUME, NO_IDX,
                _key_no(w, d_id, 0), hi_or_prow=_key_no(w, d_id + 1, 0),
                expect=_key_no(w, d_id, o_lo))
        rows[d_id] = cfg.off_new_order + d_id * ring + slot   # tombstoned
        tables[d_id] = "new_order"
        # district-group ops guarded by the consume at slot d_id: a stale
        # scan skips this district, the rest of the txn proceeds
        kinds[j] = ADD                                        # o_carrier_id
        rows[j] = cfg.off_orders + d_id * ring + slot
        deltas[j, 4] = carrier
        # order latency in order-ids: how far next_o_id advanced past this
        # order before Delivery consumed it (>= 1).  Rides the same guarded
        # ADD, so a skipped consume never stamps it; col 5 is zeroed by
        # NewOrder's whole-row SET on ring reuse (views.order_latency)
        deltas[j, 5] = int(state.next_o_id[w, d_id]) - o_id
        deltas[j, -1] = d_id + 1
        tables[j] = "orders"
        kinds[j + 1] = ADD                                    # c_balance
        rows[j + 1] = cfg.off_customer + d_id * cfg.cust_per_district + c_id
        deltas[j + 1, 2] = amount
        deltas[j + 1, -1] = d_id + 1
        tables[j + 1] = "customer"
        j += 2
    return parts, rows, kinds, deltas, False, False, tables


def _stock_level(cfg, state, rng, w):
    """Scan the district's most recent orders (orders_by_id index) and read
    their order lines + the stock rows of the distinct items.  Scaled down
    from the spec's 20 orders to what fits the fixed op budget (DESIGN.md)."""
    parts, rows, kinds, deltas, tables = _blank(w)
    d_id = int(rng.integers(0, N_DIST))
    ring = cfg.order_ring
    next_o = int(state.next_o_id[w, d_id])
    rows[IDX_OPS] = cfg.off_district + d_id
    tables[IDX_OPS] = "district"
    j = IDX_OPS + 1
    budget = M - j
    taken = 0
    seen_items = set()
    o = next_o - 1
    while o >= 3001 and o >= next_o - ring and taken < 4:
        slot = o % ring
        n = int(state.ring_olcnt[w, d_id, slot])
        its = [int(i) for i in state.ring_items[w, d_id, slot, :n] if i >= 0]
        new_items = [i for i in its if i not in seen_items]
        cost = n + len(new_items)
        if n == 0 or cost > budget:
            break
        for i in range(n):
            rows[j] = cfg.off_order_line + (d_id * ring + slot) * 15 + i
            tables[j] = "order_line"
            j += 1
        for it in new_items:
            rows[j] = cfg.off_stock + it
            tables[j] = "stock"
            seen_items.add(it)
            j += 1
        budget -= cost
        taken += 1
        o -= 1
    lo = max(3001, next_o - taken) % (1 << D_SHIFT)
    _idx_op(kinds, deltas, tables, 0, SCAN_READ, OID_IDX,
            _key_no(w, d_id, lo if taken else next_o % (1 << D_SHIFT)),
            hi_or_prow=_key_no(w, d_id, next_o % (1 << D_SHIFT)))
    return parts, rows, kinds, deltas, False, False, tables


def make_raw(cfg: TPCCConfig, state: TPCCState, n_txns: int,
             rng: np.random.Generator, txn_offset: int = 0):
    """Raw unrouted transaction request arrays — the streaming-generator
    core shared by the offline `make_batch` and the online service clients.
    `txn_offset` keeps the alternating NewOrder/Payment mix phase-correct
    across successive streamed chunks (mix="standard2"); mix="full" draws
    the standard 45/43/4/4/4 mix probabilistically per transaction.

    Returns {'parts' (B,M), 'rows', 'kinds', 'deltas', 'user_abort', 'home',
    'declared_cross', 'txn_type' (B,), 'row_bytes' (B,M), 'op_bytes' (B,M)}."""
    P = cfg.n_partitions
    full = cfg.mix == "full"
    if full:
        state.batch_floor = state.txn_gen

    all_parts, all_rows, all_kinds, all_deltas = [], [], [], []
    all_cross, all_abort, all_home, all_tables, all_type = [], [], [], [], []
    for i in range(n_txns):
        w = int(rng.integers(0, P))
        if full:
            state.txn_gen += 1
            u = rng.random()
            if u < 0.45:
                t, gen = 0, _new_order_full(cfg, state, rng, w)
            elif u < 0.88:
                t, gen = 1, _payment(cfg, rng, w)
            elif u < 0.92:
                t, gen = 2, _order_status(cfg, state, rng, w)
            elif u < 0.96:
                t, gen = 3, _delivery(cfg, state, rng, w)
            else:
                t, gen = 4, _stock_level(cfg, state, rng, w)
        elif (i + txn_offset) % 2 == 0:
            t, gen = 0, _new_order(cfg, state, rng, w)
        else:
            t, gen = 1, _payment(cfg, rng, w)
        parts, rows, kinds, deltas, cross, abort, tables = gen
        all_parts.append(parts); all_rows.append(rows); all_kinds.append(kinds)
        all_deltas.append(deltas); all_cross.append(cross)
        all_abort.append(abort); all_home.append(w); all_tables.append(tables)
        all_type.append(t)

    kinds = np.stack(all_kinds)
    txn_type = np.array(all_type, np.int32)
    return {
        "parts": np.stack(all_parts), "rows": np.stack(all_rows),
        "kinds": kinds, "deltas": np.stack(all_deltas),
        "user_abort": np.array(all_abort), "home": np.array(all_home, np.int32),
        "declared_cross": np.array(all_cross),
        "txn_type": txn_type,
        # read-only profiles (OrderStatus, StockLevel): pure READ/SCAN_READ
        # op lists — the read tier serves these from replica snapshots
        "read_only": np.isin(txn_type, READ_ONLY_TYPES),
        "row_bytes": np.array([[ROW_BYTES[t] for t in ts]
                               for ts in all_tables], np.int32),
        "op_bytes": np.vectorize(lambda k: OP_BYTES[int(k)])(kinds).astype(np.int32),
    }


def make_batch(cfg: TPCCConfig, state: TPCCState, n_txns: int,
               seed: int | None = None, raw: dict | None = None,
               T: int | None = None):
    """Route one epoch's transactions into phase queues.  ``raw`` lets a
    caller reuse an existing ``make_raw`` draw (tests/ledgers); ``T``
    overrides the per-partition slot count (benchmarks pin it so batch
    shapes — and thus compiled programs — stay constant across epochs)."""
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    P, R = cfg.n_partitions, cfg.rows_per_partition

    if raw is None:
        raw = make_raw(cfg, state, n_txns, rng)
    parts, rows = raw["parts"], raw["rows"]
    kinds, deltas = raw["kinds"], raw["deltas"]
    is_cross, abort = raw["declared_cross"], raw["user_abort"]
    home = raw["home"]
    row_bytes, op_bytes = raw["row_bytes"], raw["op_bytes"]

    single = ~is_cross
    n_single = int(single.sum())
    if T is None:
        T = max(1, int(np.ceil(n_single / P * 1.5)) + 2)
    ptxn = {
        "valid": np.zeros((P, T), bool),
        "row": np.zeros((P, T, M), np.int32),
        "kind": np.zeros((P, T, M), np.int32),
        "delta": np.zeros((P, T, M, C), np.int32),
        "user_abort": np.zeros((P, T), bool),
    }
    prow_bytes = np.zeros((P, T, M), np.int32)
    pop_bytes = np.zeros((P, T, M), np.int32)
    fill = np.zeros(P, np.int32)
    routed = 0
    for i in np.nonzero(single)[0]:
        p = home[i]
        t = fill[p]
        if t >= T:
            # dropped on queue overflow: this txn never reaches the device —
            # unwind its optimistic Delivery claims AND any NewOrder mirror
            # entry right away so no district chases a ghost order
            if cfg.mix == "full":
                unwind_never_executed(state, kinds[i, :IDX_OPS],
                                      deltas[i, :IDX_OPS])
            continue
        ptxn["valid"][p, t] = True
        ptxn["row"][p, t] = rows[i]
        ptxn["kind"][p, t] = kinds[i]
        ptxn["delta"][p, t] = deltas[i]
        ptxn["user_abort"][p, t] = abort[i]
        prow_bytes[p, t] = row_bytes[i]
        pop_bytes[p, t] = op_bytes[i]
        fill[p] += 1
        routed += 1

    cx = np.nonzero(is_cross)[0]
    cross = {
        "valid": np.ones(len(cx), bool),
        "row": (parts[cx].astype(np.int64) * R + rows[cx]).astype(np.int32),
        "kind": kinds[cx],
        "delta": deltas[cx],
        "user_abort": abort[cx],
    }
    return {
        "ptxn": ptxn, "cross": cross,
        "n_single": routed, "n_cross": len(cx),
        "p_row_bytes": prow_bytes, "p_op_bytes": pop_bytes,
        "c_row_bytes": row_bytes[cx], "c_op_bytes": op_bytes[cx],
    }


# ---------------------------------------------------------------------------
# consume feedback: resolve Delivery's optimistic claims against the device
# ---------------------------------------------------------------------------
def _prune_stale_claims(state):
    """Retire every claim whose order has been ring-evicted (it can never
    be delivered) into ``evicted_amount`` — keeps ``pending_claims``
    bounded for drivers that never call apply_consume_feedback."""
    ring = state.cfg.order_ring
    stale = [k for k, (w, d, e) in state.pending_claims.items()
             if e[0] < int(state.next_o_id[w, d]) - ring]
    for k in stale:
        state.evicted_amount += state.pending_claims.pop(k)[2][2]


def _requeue_claims(state, kinds_k, deltas_k, skipped_k=None):
    """Re-queue (or resolve) the pending claims of one txn's consume ops.

    kinds_k/deltas_k: the first IDX_OPS op slots of one transaction.
    skipped_k (optional bool per slot): True = the device skipped this
    consume → push the claimed order back to the FRONT of its district's
    undelivered queue (it is still the oldest); False = it committed →
    retire the claim.  Without skipped_k every consume is re-queued (the
    txn never executed).  A claimed order whose ring slot has meanwhile
    been overwritten can never be delivered — re-queueing it would
    permanently livelock the district on a dead prediction — so stale
    claims retire into ``evicted_amount`` instead.  Returns the number of
    re-queued districts."""
    ring = state.cfg.order_ring
    n = 0
    for k in np.nonzero(kinds_k == SCAN_CONSUME)[0]:
        key = int(deltas_k[k, IX_EXPECT])
        claim = state.pending_claims.pop(key, None)
        if claim is None:      # already resolved (e.g. duplicate feedback)
            continue
        w, d_id, entry = claim
        if skipped_k is not None and not bool(skipped_k[k]):
            continue           # consume committed: claim retired
        if entry[0] < int(state.next_o_id[w, d_id]) - ring:
            state.evicted_amount += entry[2]   # ring-evicted while claimed
            continue
        # insert preserving oldest-first order (normally position 0: the
        # claimed order predates everything still queued)
        q = state.undelivered[w][d_id]
        pos = 0
        while pos < len(q) and q[pos][0] < entry[0]:
            pos += 1
        q.insert(pos, entry)
        n += 1
    return n


def unwind_never_executed(state: TPCCState, kinds_k, deltas_k):
    """Unwind ALL host-mirror effects of one transaction that will NEVER
    reach the device (admission shed, retry-buffer drop, batch-formation
    overflow).  Two cases:

    * Delivery — its optimistic claims re-queue via ``_requeue_claims``;
    * full-mix NewOrder — the mirror ran ahead of the device at generation
      time (undelivered entry, customer last-order, ring contents, ledger
      push); erase those effects so Delivery never chases an order the
      device has no index entry for (the former ROADMAP "host mirror ahead
      of device" tail).  The o_id draw itself is NOT unwound — later draws
      may exist — which is safe: the device's next_o_id column is an
      independent counter and order rows are keyed by slot.  The one
      residual: a shed NewOrder whose generation ring-evicted a still-
      undelivered order already retired that order to ``evicted_amount``
      and its eviction DELETE_IDX never runs, leaving one unreachable
      (never-scanned) device index entry — bounded by the IndexSpec
      headroom and impossible without ring wraparound mid-run.

    kinds_k/deltas_k: the first IDX_OPS op slots of the transaction.
    Returns the number of re-queued Delivery districts."""
    n = _requeue_claims(state, kinds_k, deltas_k)
    no_ins = np.nonzero((kinds_k == INSERT_IDX)
                        & (deltas_k[:, IX_ID] == NO_IDX))[0]
    if no_ins.size == 0:
        return n
    key = int(deltas_k[no_ins[0], IX_KEY])
    w = key >> 24
    d_id = (key >> D_SHIFT) & ((1 << (24 - D_SHIFT)) - 1)
    o_lo = key & ((1 << D_SHIFT) - 1)
    entry = None
    q = state.undelivered[w][d_id]
    for i, e in enumerate(q):
        if e[0] % (1 << D_SHIFT) == o_lo:
            entry = q.pop(i)
            break
    if entry is None:
        # a Delivery generated after this NewOrder (possibly shed in the
        # same chunk) already claimed it: retire the claim — the order
        # never existed on device, so it must not be re-queued either
        claim = state.pending_claims.pop(key, None)
        if claim is not None:
            entry = claim[2]
    if entry is None:
        return n                     # ring-evicted while queued: retired
    o_id, c_id, amount = entry[0], entry[1], entry[2]
    state.pushed_amount -= amount    # the push never happened
    if int(state.last_o[w, d_id, c_id]) == o_id:
        state.last_o[w, d_id, c_id] = -1      # OrderStatus: no known order
    slot = int(o_id % state.cfg.order_ring)
    if int(state.ring_cust[w, d_id, slot]) == c_id:
        # the ring slot still describes this order (no later overwrite)
        state.ring_cust[w, d_id, slot] = -1
        state.ring_olcnt[w, d_id, slot] = 0
        state.ring_items[w, d_id, slot, :] = -1
        state.ring_qty[w, d_id, slot, :] = 0
    return n


def apply_consume_feedback(state: TPCCState, batch: dict, metrics: dict):
    """Close the consume loop (ROADMAP "service-level consume feedback"):
    a Delivery district skipped on EXPECT mismatch re-queues its claimed
    order into ``state.undelivered`` in oldest-first position (normally
    the front) instead of being only counted — the next Delivery retries
    it.  A claim whose order was meanwhile ring-evicted retires into
    ``evicted_amount`` (re-queueing a dead prediction would livelock the
    district).

    batch: the formed device batch (``make_batch`` output or the service
    batcher's equivalent — only ``ptxn``/``cross`` kind+delta arrays are
    read).  metrics: ``StarEngine.run_epoch``'s return value (``p_cskip`` /
    ``c_cskip`` masks; padded shapes are sliced to the batch's).  Returns
    the number of re-queued districts.
    """
    if not getattr(state, "pending_claims", None):
        return 0
    requeued = 0
    pk = np.asarray(batch["ptxn"]["kind"])            # (P, T, M)
    pd = np.asarray(batch["ptxn"]["delta"])
    ps = metrics.get("p_cskip")
    if ps is not None:
        P, T, M = pk.shape
        K = ps.shape[-1]
        for p in range(P):
            for t in range(T):                        # slot order == commit
                if not (pk[p, t, :K] == SCAN_CONSUME).any():
                    continue
                requeued += _requeue_claims(state, pk[p, t, :K],
                                            pd[p, t, :K], ps[p, t, :K])
    ck = np.asarray(batch["cross"]["kind"])           # (B, M)
    cd = np.asarray(batch["cross"]["delta"])
    cs = metrics.get("c_cskip")
    if cs is not None and ck.shape[0]:
        B = ck.shape[0]
        K = cs.shape[-1]
        committed = np.asarray(metrics["c_committed"])
        for b in range(B):
            if not (ck[b, :K] == SCAN_CONSUME).any():
                continue
            if not committed[b]:
                continue   # starved lane: its claim stays pending (the
                # service re-queues the txn; it resolves on commit)
            requeued += _requeue_claims(state, ck[b, :K], cd[b, :K],
                                        cs[b, :K])
    return requeued
