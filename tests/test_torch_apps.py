"""The port's applications against the reference's, on the CPU.

The reference's own app cases (tests/test_apps.py: the counter, the KV
store, notifications, banking, sharding and operation batches; the
binary op codec's store cases of tests/test_blocks.py) run over both
packages. Then the two packages are held to each other on one seeded
stream: responses, ``checksum()``, snapshot bytes with the wall clock
pinned (a snapshot carries ``created_at`` / ``updated_at`` stamps), and
snapshots restored across packages in both directions; ``shard_for_key``
on 10k keys at several shard counts. The reference's native store
(``make_sharded_kv(native=True)``, where its library is built) is held
to the same stream. Tolerance: exact equality (bytes, ints, strings).
"""

from __future__ import annotations

import functools
import importlib
import json
import time
import types

import numpy as np
import pytest

PACKAGES = ("rabia_tpu", "rabia_tpu_torch")
PINNED_NOW = 1700000000.25


def _pkg(name: str) -> types.SimpleNamespace:
    def m(sub):
        return importlib.import_module(f"{name}.{sub}")

    apps = m("apps")
    ns = types.SimpleNamespace(
        name=name,
        apps=apps,
        kv=m("apps.kvstore"),
        counter=m("apps.counter"),
        banking=m("apps.banking"),
        sharded=m("apps.sharded"),
        config=m("core.config"),
        smr=m("core.smr"),
        types=m("core.types"),
    )
    # the reference picks its native store when its library is built: the
    # Python store is the semantics owner the port copies
    ns.make_sharded_kv = functools.partial(apps.make_sharded_kv, native=False)
    return ns


@pytest.fixture(params=PACKAGES)
def P(request):
    return _pkg(request.param)


@pytest.fixture
def pinned_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: PINNED_NOW)


# -- the reference's cases (tests/test_apps.py) over both packages ---------


class TestCounter:
    def test_increment_decrement_set_reset(self, P):
        C = P.apps.CounterCommand
        sm = P.apps.CounterSMR()
        assert sm.apply_command(C.increment(5)).value == 5
        assert sm.apply_command(C.decrement(2)).value == 3
        assert sm.apply_command(C.set(100)).value == 100
        assert sm.apply_command(C.reset()).value == 0
        assert sm.operations == 4

    def test_overflow_rejected_deterministically(self, P):
        C = P.apps.CounterCommand
        sm = P.apps.CounterSMR()
        sm.apply_command(C.set((1 << 63) - 1))
        r = sm.apply_command(C.increment(1))
        assert not r.ok and r.error == "overflow"
        assert sm.value == (1 << 63) - 1
        assert sm.operations == 2

    def test_underflow_rejected(self, P):
        C = P.apps.CounterCommand
        sm = P.apps.CounterSMR()
        sm.apply_command(C.set(-(1 << 63)))
        r = sm.apply_command(C.decrement(1))
        assert not r.ok and r.error == "underflow"

    def test_command_response_roundtrip(self, P):
        sm = P.apps.CounterSMR()
        cmd = P.apps.CounterCommand.increment(7)
        assert sm.decode_command(sm.encode_command(cmd)) == cmd
        resp = sm.apply_command(cmd)
        assert sm.decode_response(sm.encode_response(resp)) == resp

    def test_state_roundtrip_via_bridge(self, P):
        sm = P.apps.CounterSMR()
        bridge = P.smr.SMRBridge(sm)
        bridge.apply_command(
            P.types.Command.new(sm.encode_command(P.apps.CounterCommand.increment(41)))
        )
        snap = bridge.create_snapshot()
        sm2 = P.apps.CounterSMR()
        P.smr.SMRBridge(sm2).restore_snapshot(snap)
        assert sm2.value == 41


class TestKVStore:
    def test_crud(self, P):
        s = P.apps.KVStore()
        assert s.set("a", "1").ok
        assert s.get("a").value == "1"
        assert s.exists("a").value == "true"
        assert s.delete("a").value == "1"
        assert s.get("a").kind == P.apps.KVResultKind.NotFound

    def test_versions_monotone(self, P):
        s = P.apps.KVStore()
        v1 = s.set("k", "x").version
        v2 = s.set("k", "y").version
        assert v2 > v1
        meta = s.get_with_metadata("k")
        assert meta.version == v2 and meta.value == "y"

    def test_key_validation(self, P):
        s = P.apps.KVStore(P.config.KVStoreConfig(max_key_length=4))
        with pytest.raises(P.apps.StoreError):
            s.set("toolongkey", "v")
        with pytest.raises(P.apps.StoreError):
            s.set("", "v")

    def test_value_size_limit(self, P):
        s = P.apps.KVStore(P.config.KVStoreConfig(max_value_size=8))
        with pytest.raises(P.apps.StoreError):
            s.set("k", "x" * 100)

    def test_max_keys(self, P):
        s = P.apps.KVStore(P.config.KVStoreConfig(max_keys=2))
        s.set("a", "1")
        s.set("b", "2")
        with pytest.raises(P.apps.StoreError):
            s.set("c", "3")
        s.set("a", "updated")  # updates never hit the cap

    def test_keys_prefix_listing(self, P):
        s = P.apps.KVStore()
        for k in ["user:1", "user:2", "order:1"]:
            s.set(k, "x")
        assert s.keys("user:") == ["user:1", "user:2"]
        assert len(s.keys()) == 3

    def test_snapshot_roundtrip_and_checksum(self, P):
        s = P.apps.KVStore()
        s.set("a", "1")
        s.set("b", "2")
        blob = s.snapshot_bytes()
        s2 = P.apps.KVStore()
        s2.restore_bytes(blob)
        assert s2.get("a").value == "1"
        assert s.checksum() == s2.checksum()

    def test_snapshot_corruption_detected(self, P):
        s = P.apps.KVStore()
        s.set("a", "1")
        blob = bytearray(s.snapshot_bytes())
        blob[10] ^= 0xFF
        with pytest.raises(P.apps.StoreError):
            P.apps.KVStore().restore_bytes(bytes(blob))

    def test_batch_apply(self, P):
        s = P.apps.KVStore()
        Op, K = P.apps.KVOperation, P.apps.KVResultKind
        results = s.apply_operations([Op.set("x", "1"), Op.get("x"), Op.delete("x"), Op.get("x")])
        assert [r.kind for r in results] == [K.Success, K.Success, K.Success, K.NotFound]


class TestNotifications:
    def test_filters(self, P):
        F, CT = P.apps.NotificationFilter, P.apps.ChangeType
        s = P.apps.KVStore()
        bus = s.notifications
        all_sub = bus.subscribe()
        key_sub = bus.subscribe(F.key("a"))
        prefix_sub = bus.subscribe(F.key_prefix("user:"))
        type_sub = bus.subscribe(F.change_type(CT.Deleted))
        s.set("a", "1")
        s.set("user:7", "x")
        s.delete("a")
        assert all_sub.queue.qsize() == 3
        assert key_sub.queue.qsize() == 2  # created + deleted for "a"
        assert prefix_sub.queue.qsize() == 1
        assert type_sub.queue.qsize() == 1
        n = type_sub.get_nowait()
        assert n.change == CT.Deleted and n.old_value == "1"

    def test_and_or_composition(self, P):
        F, CT = P.apps.NotificationFilter, P.apps.ChangeType
        s = P.apps.KVStore()
        sub = s.notifications.subscribe(F.key_prefix("u:").and_(F.change_type(CT.Created)))
        s.set("u:1", "a")  # match
        s.set("u:1", "b")  # update: no
        s.set("v:1", "c")  # prefix: no
        assert sub.queue.qsize() == 1

    def test_closed_subscriber_gc(self, P):
        s = P.apps.KVStore()
        bus = s.notifications
        sub = bus.subscribe()
        sub.close()
        s.set("k", "v")
        assert bus.stats.active_subscribers == 0

    @pytest.mark.asyncio
    async def test_async_iteration_ends_on_close(self, P):
        s = P.apps.KVStore()
        sub = s.notifications.subscribe()
        s.set("k", "v")
        s.delete("k")
        sub.close()
        got = [n.change.value async for n in sub]
        assert got == ["created", "deleted"]


class TestBanking:
    def test_deposit_withdraw_transfer(self, P):
        B = P.apps.BankCommand
        b = P.apps.BankingSMR()
        assert b.apply_command(B.create("alice", 10_00)).ok
        assert b.apply_command(B.create("bob")).ok
        assert b.apply_command(B.deposit("bob", 5_00)).ok
        r = b.apply_command(B.transfer("alice", "bob", 3_00))
        assert r.ok and r.balance_cents == 7_00
        assert b.apply_command(B.balance("bob")).balance_cents == 8_00

    def test_conservation_invariant(self, P):
        B = P.apps.BankCommand
        b = P.apps.BankingSMR()
        b.apply_command(B.create("a", 100_00))
        b.apply_command(B.create("b", 50_00))
        total = b.total_value()
        for _ in range(10):
            b.apply_command(B.transfer("a", "b", 1_00))
            b.apply_command(B.transfer("b", "a", 1_00))
        assert b.total_value() == total

    def test_validation(self, P):
        B = P.apps.BankCommand
        b = P.apps.BankingSMR()
        b.apply_command(B.create("a", 1_00))
        assert not b.apply_command(B.deposit("a", -5)).ok
        assert not b.apply_command(B.deposit("a", 10_000_000_01)).ok
        assert not b.apply_command(B.withdraw("a", 2_00)).ok
        assert not b.apply_command(B.transfer("a", "a", 1)).ok
        assert not b.apply_command(B.transfer("a", "ghost", 1)).ok
        assert b.total_value() == 1_00

    def test_state_roundtrip(self, P):
        B = P.apps.BankCommand
        b = P.apps.BankingSMR()
        b.apply_command(B.create("x", 42_00))
        blob = b.serialize_state()
        b2 = P.apps.BankingSMR()
        b2.deserialize_state(blob)
        assert b2.apply_command(B.balance("x")).balance_cents == 42_00
        assert b2.total_value() == b.total_value()


class TestSharding:
    def test_shard_for_key_stable_and_spread(self, P):
        f = P.apps.shard_for_key
        assert f("k", 8) == f("k", 8)
        assert len({f(f"key{i}", 8) for i in range(200)}) == 8  # every shard reached

    def test_sharded_sm_routes_by_batch_shard(self, P):
        sm, machines = P.make_sharded_kv(4)
        op = machines[2].encode_command(P.apps.KVOperation.set("hello", "world"))
        batch = P.types.CommandBatch.new([P.types.Command.new(op)], shard=P.types.ShardId(2))
        sm.apply_batch(batch)
        assert machines[2].store.get("hello").value == "world"
        assert machines[0].store.size() == 0

    def test_sharded_snapshot_roundtrip(self, P):
        sm, machines = P.make_sharded_kv(3)
        for i, m in enumerate(machines):
            m.store.set(f"k{i}", str(i))
        snap = sm.create_snapshot()
        sm2, machines2 = P.make_sharded_kv(3)
        sm2.restore_snapshot(snap)
        for i, m in enumerate(machines2):
            assert m.store.get(f"k{i}").value == str(i)


class TestOperationBatch:
    def test_batch_introspection(self, P):
        Op = P.apps.KVOperation
        b = P.apps.OperationBatch.new([Op.set("a", "1"), Op.get("b"), Op.delete("c")])
        assert b.size() == 3
        assert b.has_write_operations() and not b.is_read_only()
        assert b.affected_keys() == ["a", "b", "c"]
        assert b.batch_id  # unique id assigned
        assert P.apps.OperationBatch.new([Op.get("a"), Op.exists("b")]).is_read_only()

    def test_execute_batch_reports_outcomes(self, P):
        Op = P.apps.KVOperation
        store = P.apps.KVStore()
        batch = P.apps.OperationBatch.new([Op.set("k", "v"), Op.get("k"), Op.get("missing")])
        res = store.execute_batch(batch)
        assert res.batch_id == batch.batch_id
        assert (res.success_count, res.failure_count) == (2, 1)
        assert res.has_failures() and not res.all_succeeded()
        assert abs(res.success_rate() - 200 / 3) < 1e-9  # the reference case's own bound
        assert res.execution_time_ms >= 0
        assert res.results[1].value == "v"

    def test_empty_batch_success_rate_zero(self, P):
        res = P.apps.KVStore().execute_batch(P.apps.OperationBatch.new([]))
        assert res.success_rate() == 0.0 and res.all_succeeded()


# -- the binary op codec's store cases (tests/test_blocks.py) --------------


class TestBinaryOpCodec:
    def test_roundtrip_all_ops(self, P):
        Op = P.kv.KVOperation
        for op in (Op.set("k", "v"), Op.get("k"), Op.delete("k"), Op.exists("k")):
            assert P.kv.decode_op_bin(P.kv.encode_op_bin(op)) == op

    def test_apply_matches_typed_store(self, P):
        a, b = P.kv.KVStore(), P.kv.KVStore()
        r1 = P.kv.apply_op_bin(a, P.kv.encode_set_bin("x", "1"))
        r2 = b.set("x", "1")
        assert P.kv.decode_result_bin(r1).version == r2.version
        get = P.kv.encode_op_bin(P.kv.KVOperation.get("x"))
        assert P.kv.decode_result_bin(P.kv.apply_op_bin(a, get)).value == "1"

    def test_bulk_apply_equivalent_to_sequential(self, P):
        bulk, seq = P.kv.KVStore(), P.kv.KVStore()
        ops = [P.kv.encode_set_bin(f"k{i % 5}", f"v{i}") for i in range(40)]
        bulk_out = P.kv.apply_ops_bin(bulk, ops)
        seq_out = [P.kv.apply_op_bin(seq, b) for b in ops]
        assert [P.kv.decode_result_bin(r).version for r in bulk_out] == [
            P.kv.decode_result_bin(r).version for r in seq_out
        ]
        assert {k: e.value for k, e in bulk._data.items()} == {
            k: e.value for k, e in seq._data.items()
        }

    def test_fast_path_respects_notifications(self, P):
        st = P.kv.KVStore()
        sub = st.notifications.subscribe()
        # the fast path declines while subscribers exist (notify semantics)
        assert st.apply_set_bin_fast(P.kv.encode_set_bin("k", "v"), time.time()) is None
        st.set("k", "v")
        assert sub.queue.qsize() == 1


# -- cross-package: one seeded stream through both packages ---------------

N_OPS = 3000


def _kv_stream(seed: int, n: int = N_OPS) -> list:
    """Seeded (kind, key, value, expected_version) tuples over a small key
    space (so updates, deletes, conflicts and misses all occur), with a
    few invalid keys and values and one CLEAR."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["set", "get", "delete", "exists", "cas", "bad"], size=n,
                       p=[0.4, 0.2, 0.12, 0.08, 0.17, 0.03])
    keys = rng.integers(0, 40, size=n)
    vals = rng.integers(0, 1 << 30, size=n)
    evs = rng.integers(0, 6, size=n)
    out = []
    for i in range(n):
        kind = str(kinds[i])
        if kind == "bad":
            kind, key = ("set", "") if i % 2 else ("set", "k" * 300)
        else:
            key = f"key-{int(keys[i])}"
        out.append((kind, key, f"v{int(vals[i])}", int(evs[i])))
    out.insert(n // 2, ("clear", "", "", 0))
    return out


def _op_of(P, kind, key, value, ev):
    Op = P.kv.KVOperation
    if kind == "clear":
        return Op(P.kv.KVOpType.Clear)
    if kind == "set":
        return Op.set(key, value)
    if kind == "cas":
        return Op.cas(key, value, ev)
    return getattr(Op, kind)(key)


def _sans_created(blob: bytes) -> bytes:
    """A banking state with each account's ``created_at`` zeroed: the
    Account dataclass stamps it from the clock it captured at import,
    which pinning time.time does not reach."""
    doc = json.loads(blob)
    for acct in doc["accounts"].values():
        acct[1] = 0.0
    return json.dumps(doc, sort_keys=True).encode()


def _res(r) -> tuple:
    return (r.kind.value, r.value, r.version, r.error)


class TestCrossPackage:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_kvstore_stream(self, seed, pinned_clock):
        stores = [_pkg(n).kv.KVStore() for n in PACKAGES]
        subs = [s.notifications.subscribe() for s in stores]
        outs = [[], []]
        for step in _kv_stream(seed):
            for i, name in enumerate(PACKAGES):
                P = _pkg(name)
                op = _op_of(P, *step)
                outs[i].append([_res(r) for r in stores[i].apply_operations([op])])
        assert outs[0] == outs[1]
        assert stores[0].checksum() == stores[1].checksum()
        assert stores[0].snapshot_bytes() == stores[1].snapshot_bytes()
        assert stores[0].version == stores[1].version
        assert json.dumps(stores[0].stats.__dict__) == json.dumps(stores[1].stats.__dict__)
        # (a notification's timestamp is the clock its dataclass captured
        # at import, which pinning time.time does not reach)
        notes = [[(n.key, n.change.value, n.old_value, n.new_value, n.version)
                  for n in iter(s.get_nowait, None)] for s in subs]
        assert notes[0] == notes[1] and len(notes[0]) > 100

    @pytest.mark.parametrize("seed", [2, 3])
    def test_binary_apply_stream(self, seed, pinned_clock):
        """The bulk binary apply (waves of 16 records) and the one-op
        apply, through both packages and through the reference's native
        store where its library is built: every result frame equal."""
        ref, port = _pkg("rabia_tpu"), _pkg("rabia_tpu_torch")
        stream = [port.kv.encode_op_bin(_op_of(port, *s)) for s in _kv_stream(seed)]
        stream.append(b"\x09\x01\x00k")  # unknown opcode
        stream.append(b"\x01\x05\x00ab")  # key length past the payload
        stream.append(b"\x01\x01\x00k\xff\xfe")  # invalid utf-8 value
        stores = [ref.kv.KVStore(), port.kv.KVStore()]
        waves = [stream[i:i + 16] for i in range(0, len(stream), 16)]
        bulk = [[bytes(r) for w in waves for r in P.kv.apply_ops_bin(s, w)]
                for P, s in zip((ref, port), stores)]
        assert bulk[0] == bulk[1]
        assert stores[0].checksum() == stores[1].checksum()
        assert stores[0].snapshot_bytes() == stores[1].snapshot_bytes()
        one = [P.kv.KVStore() for P in (ref, port)]
        singles = [[bytes(P.kv.apply_op_bin(s, b)) for b in stream]
                   for P, s in zip((ref, port), one)]
        assert singles[0] == singles[1]
        assert one[1].checksum() == stores[1].checksum()
        try:
            from rabia_tpu.apps.native_store import native_apply_available
        except ImportError:  # pragma: no cover - the reference always has the module
            native_apply_available = None
        if native_apply_available is not None and native_apply_available():
            _sm, machines = ref.apps.make_sharded_kv(1, native=True)
            native = machines[0].store
            got = [bytes(r) for w in waves for r in ref.kv.apply_ops_bin(native, w)]
            assert got == bulk[1]
            assert native.checksum() == stores[1].checksum()

    def test_snapshots_restore_across_packages(self, pinned_clock):
        ref, port = _pkg("rabia_tpu"), _pkg("rabia_tpu_torch")
        for src, dst in ((ref, port), (port, ref)):
            a = src.kv.KVStore()
            for step in _kv_stream(4, 500):
                a.apply_operations([_op_of(src, *step)])
            b = dst.kv.KVStore()
            b.restore_bytes(a.snapshot_bytes())
            assert b.checksum() == a.checksum()
            assert b.snapshot_bytes() == a.snapshot_bytes()
            assert b.keys() == a.keys()
            # the restored store goes on like the original
            for step in _kv_stream(5, 300):
                assert _res(a.apply_operations([_op_of(src, *step)])[0]) == _res(
                    b.apply_operations([_op_of(dst, *step)])[0])
            assert b.checksum() == a.checksum()

    def test_kvstore_smr_stream(self, pinned_clock):
        """KVStoreSMR: JSON and binary commands, apply_raw / apply_raw_many,
        the typed state, and serialize / deserialize across packages."""
        ref, port = _pkg("rabia_tpu"), _pkg("rabia_tpu_torch")
        smrs = [P.kv.KVStoreSMR() for P in (ref, port)]
        outs = [[], []]
        for j, step in enumerate(_kv_stream(6, 1500)):
            for i, P in enumerate((ref, port)):
                op = _op_of(P, *step)
                if j % 3 == 0:
                    raw = smrs[i].encode_command(op)  # JSON
                    outs[i].append(bytes(smrs[i].apply_raw(raw)))
                elif j % 3 == 1:
                    outs[i].append(bytes(smrs[i].apply_raw(P.kv.encode_op_bin(op))))
                else:
                    outs[i].append(_res(smrs[i].apply_command(op)))
        assert outs[0] == outs[1]
        many = [[bytes(r) for r in s.apply_raw_many(
            [P.kv.encode_set_bin(f"m{k}", f"x{k}") for k in range(50)])]
            for P, s in zip((ref, port), smrs)]
        assert many[0] == many[1]
        assert smrs[0].get_state() == smrs[1].get_state()
        assert smrs[0].serialize_state() == smrs[1].serialize_state()
        for src, dst in ((0, 1), (1, 0)):
            fresh = (ref, port)[dst].kv.KVStoreSMR()
            fresh.deserialize_state(smrs[src].serialize_state())
            assert fresh.store.checksum() == smrs[src].store.checksum()
            # set_state stamps the clock: pinned, both packages agree
            typed = (ref, port)[dst].kv.KVStoreSMR()
            typed.set_state(smrs[src].get_state())
            assert typed.get_state() == smrs[src].get_state()
        states = []
        for P in (ref, port):
            t = P.kv.KVStoreSMR()
            t.set_state(smrs[0].get_state())
            states.append(t.serialize_state())
        assert states[0] == states[1]

    def test_counter_stream(self):
        ref, port = _pkg("rabia_tpu"), _pkg("rabia_tpu_torch")
        rng = np.random.default_rng(7)
        sms = [P.apps.CounterSMR() for P in (ref, port)]
        outs = [[], []]
        big = (1 << 63) - 3
        for _ in range(N_OPS):
            kind = int(rng.integers(0, 5))
            amount = int(rng.integers(0, 1000))
            for i, P in enumerate((ref, port)):
                C = P.apps.CounterCommand
                cmd = [C.increment(amount), C.decrement(amount), C.set(amount - 500),
                       C.set(big if amount % 2 else -big), C.get()][kind]
                raw = sms[i].encode_command(cmd)
                outs[i].append((raw, bytes(sms[i].encode_response(
                    sms[i].apply_command(sms[i].decode_command(raw))))))
        assert outs[0] == outs[1]
        assert sms[0].serialize_state() == sms[1].serialize_state()
        assert (sms[0].value, sms[0].operations) == (sms[1].value, sms[1].operations)
        for src, dst in ((0, 1), (1, 0)):
            fresh = (ref, port)[dst].apps.CounterSMR()
            fresh.deserialize_state(sms[src].serialize_state())
            assert fresh.serialize_state() == sms[src].serialize_state()

    def test_banking_stream(self):
        ref, port = _pkg("rabia_tpu"), _pkg("rabia_tpu_torch")
        rng = np.random.default_rng(8)
        sms = [P.apps.BankingSMR() for P in (ref, port)]
        outs = [[], []]
        for _ in range(N_OPS):
            kind = int(rng.integers(0, 6))
            a, b = (f"acct{int(x)}" for x in rng.integers(0, 12, size=2))
            amount = int(rng.integers(-50, 50_000))
            for i, P in enumerate((ref, port)):
                B = P.apps.BankCommand
                cmd = [B.create(a, max(amount, 0)), B.deposit(a, amount), B.withdraw(a, amount),
                       B.transfer(a, b, amount), B.balance(a), B.transfer(b, a, amount // 3)][kind]
                raw = sms[i].encode_command(cmd)
                outs[i].append((raw, bytes(sms[i].encode_response(
                    sms[i].apply_command(sms[i].decode_command(raw))))))
        assert outs[0] == outs[1]
        assert sms[0].total_value() == sms[1].total_value()
        assert _sans_created(sms[0].serialize_state()) == _sans_created(sms[1].serialize_state())
        for src, dst in ((0, 1), (1, 0)):
            fresh = (ref, port)[dst].apps.BankingSMR()
            fresh.deserialize_state(sms[src].serialize_state())
            assert fresh.serialize_state() == sms[src].serialize_state()
            assert fresh.total_value() == sms[src].total_value()

    @pytest.mark.parametrize("n_shards", [1, 2, 7, 64, 1024, 4096])
    def test_shard_for_key(self, n_shards):
        ref, port = _pkg("rabia_tpu"), _pkg("rabia_tpu_torch")
        rng = np.random.default_rng(n_shards)
        keys = [f"k{i}" for i in range(5000)] + [
            bytes(rng.integers(33, 127, size=int(rng.integers(1, 33)), dtype=np.uint8)).decode()
            for _ in range(5000)
        ]
        got = [[P.apps.shard_for_key(k, n_shards) for k in keys] for P in (ref, port)]
        assert got[0] == got[1]
        if n_shards <= 64:
            assert len(set(got[1])) == n_shards  # every shard reached

    def test_sharded_sm_apply_block_and_restore_shards(self, pinned_clock):
        """ShardedStateMachine's block lane apply (the fused one-SET path
        and the bulk path), its snapshot, and restore_shards, across
        packages."""
        ref, port = _pkg("rabia_tpu"), _pkg("rabia_tpu_torch")
        S = 8
        rng = np.random.default_rng(9)
        pairs = [P.make_sharded_kv(S) for P in (ref, port)]
        blocks_mod = [importlib.import_module(f"{n}.core.blocks") for n in PACKAGES]
        outs = [[], []]
        for w in range(20):
            shards = sorted(rng.choice(S, size=int(rng.integers(1, S + 1)), replace=False).tolist())
            per = [[port.kv.encode_op_bin(_op_of(port, *step))
                    for step in _kv_stream(100 * w + s, int(rng.integers(1, 5)))]
                   for s in shards]
            for i in range(2):
                block = blocks_mod[i].build_block(shards, per)
                got = pairs[i][0].apply_block(block, np.arange(len(shards)))
                outs[i].append([[bytes(r) for r in g] for g in got])
        assert outs[0] == outs[1]
        assert [m.store.checksum() for m in pairs[0][1]] == [m.store.checksum() for m in pairs[1][1]]
        snaps = [p[0].create_snapshot() for p in pairs]
        assert snaps[0].to_bytes() == snaps[1].to_bytes()
        for src, dst in ((0, 1), (1, 0)):
            sm, machines = (ref, port)[dst].make_sharded_kv(S)
            snap = importlib.import_module(f"{PACKAGES[dst]}.core.state_machine").Snapshot
            sm.restore_shards(snap.from_bytes(snaps[src].to_bytes()), [1, 5])
            assert [m.store.checksum() for m in machines] == [
                pairs[src][1][s].store.checksum() if s in (1, 5) else machines[s].store.checksum()
                for s in range(S)
            ]
            assert machines[0].store.size() == 0
