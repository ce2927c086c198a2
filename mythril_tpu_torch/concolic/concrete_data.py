"""ConcreteData: the JSON schema shared by witness reports and concolic input
(capability parity: mythril/concolic/concrete_data.py — the TypedDict schema of
initialState + steps; analysis/solver.get_transaction_sequence emits it, the
concolic CLI consumes it).

The port's copy of mythril_tpu/concolic/concrete_data.py."""

from __future__ import annotations

from typing import Dict, List, TypedDict


class AccountData(TypedDict):
    nonce: int
    code: str
    storage: Dict[str, str]
    balance: str


class InitialState(TypedDict):
    accounts: Dict[str, AccountData]


class TransactionData(TypedDict, total=False):
    address: str
    input: str
    origin: str
    value: str
    gasLimit: str
    gasPrice: str
    name: str
    calldata: str


class ConcreteData(TypedDict):
    initialState: InitialState
    steps: List[TransactionData]


def validate_concrete_data(data: dict) -> None:
    if "initialState" not in data or "steps" not in data:
        raise ValueError("ConcreteData needs initialState and steps")
    if "accounts" not in data["initialState"]:
        raise ValueError("initialState needs accounts")
    for step in data["steps"]:
        if "input" not in step:
            raise ValueError("every step needs an input field")
