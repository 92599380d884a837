"""Banking SMR app: validated transfers with a conservation invariant.

Reference parity: examples/banking_smr/src/lib.rs — `Account` in integer
cents (:40-77), commands Deposit/Withdraw/Transfer + account management
(:104-133), validation (positive amounts, per-transaction cap $10M,
balance checks) and state with transaction history + the `total_value`
conservation invariant (:186-261).
"""

from __future__ import annotations

import enum
import json
import time
from dataclasses import dataclass, field
from typing import Optional

from rabia_tpu_torch.core.errors import StateMachineError
from rabia_tpu_torch.core.smr import TypedStateMachine

MAX_TRANSACTION_CENTS = 10_000_000_00  # $10M per transaction (lib.rs cap)
MAX_HISTORY = 10_000


class BankOp(enum.Enum):
    CreateAccount = "create"
    Deposit = "deposit"
    Withdraw = "withdraw"
    Transfer = "transfer"
    GetBalance = "balance"
    ListAccounts = "list"


@dataclass(frozen=True)
class BankCommand:
    """One typed banking command (banking_smr lib.rs:104-133)."""

    op: BankOp
    account: str = ""
    to_account: str = ""
    amount_cents: int = 0

    @staticmethod
    def create(account: str, initial_cents: int = 0) -> "BankCommand":
        return BankCommand(BankOp.CreateAccount, account, amount_cents=initial_cents)

    @staticmethod
    def deposit(account: str, cents: int) -> "BankCommand":
        return BankCommand(BankOp.Deposit, account, amount_cents=cents)

    @staticmethod
    def withdraw(account: str, cents: int) -> "BankCommand":
        return BankCommand(BankOp.Withdraw, account, amount_cents=cents)

    @staticmethod
    def transfer(src: str, dst: str, cents: int) -> "BankCommand":
        return BankCommand(BankOp.Transfer, src, dst, cents)

    @staticmethod
    def balance(account: str) -> "BankCommand":
        return BankCommand(BankOp.GetBalance, account)


@dataclass(frozen=True)
class BankResponse:
    ok: bool
    balance_cents: Optional[int] = None
    accounts: Optional[tuple[str, ...]] = None
    error: Optional[str] = None

    @staticmethod
    def err(message: str) -> "BankResponse":
        return BankResponse(ok=False, error=message)


@dataclass
class Account:
    """Integer-cent account (lib.rs:40-77) — floats never touch money."""

    balance_cents: int = 0
    created_at: float = field(default_factory=time.time)
    transactions: int = 0


@dataclass(frozen=True)
class TransactionRecord:
    op: str
    account: str
    to_account: str
    amount_cents: int
    seq: int


class BankingSMR(TypedStateMachine[BankCommand, BankResponse, dict]):
    """Deterministic bank with validated mutations (lib.rs:186-261).

    Invariant: `total_value()` changes only via Deposit/Withdraw — a
    Transfer conserves the sum exactly (checked by tests and the fault
    harness after every scenario).
    """

    def __init__(self) -> None:
        self._accounts: dict[str, Account] = {}
        self._history: list[TransactionRecord] = []
        self._seq = 0
        self._cmd_cache: dict[bytes, BankCommand] = {}

    # -- invariant ----------------------------------------------------------

    def total_value(self) -> int:
        return sum(a.balance_cents for a in self._accounts.values())

    @property
    def accounts(self) -> dict[str, Account]:
        return self._accounts

    def history(self) -> list[TransactionRecord]:
        return list(self._history)

    # -- validation ---------------------------------------------------------

    @staticmethod
    def _validate_amount(cents: int) -> Optional[str]:
        if cents <= 0:
            return "amount must be positive"
        if cents > MAX_TRANSACTION_CENTS:
            return "amount exceeds per-transaction cap"
        return None

    def _record(self, cmd: BankCommand) -> None:
        self._seq += 1
        self._history.append(
            TransactionRecord(
                cmd.op.value, cmd.account, cmd.to_account, cmd.amount_cents, self._seq
            )
        )
        if len(self._history) > MAX_HISTORY:
            del self._history[: len(self._history) - MAX_HISTORY]

    # -- apply --------------------------------------------------------------

    def apply_command(self, command: BankCommand) -> BankResponse:
        self._bump_version()
        op = command.op
        if op == BankOp.CreateAccount:
            if not command.account:
                return BankResponse.err("account name required")
            if command.account in self._accounts:
                return BankResponse.err("account exists")
            if command.amount_cents < 0:
                return BankResponse.err("negative initial balance")
            self._accounts[command.account] = Account(command.amount_cents)
            self._record(command)
            return BankResponse(ok=True, balance_cents=command.amount_cents)

        if op == BankOp.GetBalance:
            acct = self._accounts.get(command.account)
            if acct is None:
                return BankResponse.err("no such account")
            return BankResponse(ok=True, balance_cents=acct.balance_cents)

        if op == BankOp.ListAccounts:
            return BankResponse(ok=True, accounts=tuple(sorted(self._accounts)))

        if op == BankOp.Deposit:
            err = self._validate_amount(command.amount_cents)
            if err:
                return BankResponse.err(err)
            acct = self._accounts.get(command.account)
            if acct is None:
                return BankResponse.err("no such account")
            acct.balance_cents += command.amount_cents
            acct.transactions += 1
            self._record(command)
            return BankResponse(ok=True, balance_cents=acct.balance_cents)

        if op == BankOp.Withdraw:
            err = self._validate_amount(command.amount_cents)
            if err:
                return BankResponse.err(err)
            acct = self._accounts.get(command.account)
            if acct is None:
                return BankResponse.err("no such account")
            if acct.balance_cents < command.amount_cents:
                return BankResponse.err("insufficient funds")
            acct.balance_cents -= command.amount_cents
            acct.transactions += 1
            self._record(command)
            return BankResponse(ok=True, balance_cents=acct.balance_cents)

        if op == BankOp.Transfer:
            err = self._validate_amount(command.amount_cents)
            if err:
                return BankResponse.err(err)
            src = self._accounts.get(command.account)
            dst = self._accounts.get(command.to_account)
            if src is None or dst is None:
                return BankResponse.err("no such account")
            if command.account == command.to_account:
                return BankResponse.err("self-transfer")
            if src.balance_cents < command.amount_cents:
                return BankResponse.err("insufficient funds")
            src.balance_cents -= command.amount_cents
            dst.balance_cents += command.amount_cents
            src.transactions += 1
            dst.transactions += 1
            self._record(command)
            return BankResponse(ok=True, balance_cents=src.balance_cents)

        return BankResponse.err("unknown op")  # pragma: no cover

    # -- state --------------------------------------------------------------

    def get_state(self) -> dict:
        return {k: a.balance_cents for k, a in self._accounts.items()}

    def set_state(self, state: dict) -> None:
        self._accounts = {k: Account(int(v)) for k, v in state.items()}

    # -- codecs -------------------------------------------------------------

    def encode_command(self, command: BankCommand) -> bytes:
        return json.dumps(
            {
                "op": command.op.value,
                "account": command.account,
                "to": command.to_account,
                "cents": command.amount_cents,
            },
            separators=(",", ":"),
        ).encode()

    def decode_command(self, data: bytes) -> BankCommand:
        # bounded decode cache: commands are immutable and command bytes
        # repeat heavily under hot accounts (a deposit storm decodes ONE
        # JSON doc, not one per committed slot) — the config-4 profile
        # showed per-op json.loads as the largest apply-path cost
        if not isinstance(data, bytes):  # bytearray/memoryview callers
            data = bytes(data)
        cached = self._cmd_cache.get(data)
        if cached is not None:
            return cached
        try:
            doc = json.loads(data.decode())
            cmd = BankCommand(
                BankOp(doc["op"]),
                doc.get("account", ""),
                doc.get("to", ""),
                int(doc.get("cents", 0)),
            )
        except (ValueError, KeyError, UnicodeDecodeError) as e:
            raise StateMachineError(f"bad bank command: {e}") from None
        if len(self._cmd_cache) > 4096:  # bound against command spraying
            self._cmd_cache.clear()
        self._cmd_cache[data] = cmd
        return cmd

    def encode_response(self, response: BankResponse) -> bytes:
        if response.accounts is None and response.error is None:
            # the steady-state shape (ok + balance): hand-framed,
            # byte-identical to the json.dumps output below
            bal = response.balance_cents
            return (
                '{"ok":%s,"balance":%s,"accounts":null,"error":null}'
                % (
                    "true" if response.ok else "false",
                    "null" if bal is None else bal,
                )
            ).encode()
        return json.dumps(
            {
                "ok": response.ok,
                "balance": response.balance_cents,
                "accounts": list(response.accounts) if response.accounts else None,
                "error": response.error,
            },
            separators=(",", ":"),
        ).encode()

    def decode_response(self, data: bytes) -> BankResponse:
        doc = json.loads(data)
        return BankResponse(
            ok=bool(doc["ok"]),
            balance_cents=doc.get("balance"),
            accounts=tuple(doc["accounts"]) if doc.get("accounts") else None,
            error=doc.get("error"),
        )

    def serialize_state(self) -> bytes:
        doc = {
            "seq": self._seq,
            "accounts": {
                k: [a.balance_cents, a.created_at, a.transactions]
                for k, a in sorted(self._accounts.items())
            },
        }
        return json.dumps(doc, separators=(",", ":"), sort_keys=True).encode()

    def deserialize_state(self, data: bytes) -> None:
        doc = json.loads(data)
        self._seq = int(doc["seq"])
        self._accounts = {
            k: Account(int(v[0]), float(v[1]), int(v[2]))
            for k, v in doc["accounts"].items()
        }
        self._history = []
