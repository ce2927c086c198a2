"""Witness extraction: concrete exploit transaction sequences
(capability parity: mythril/analysis/solver.py — get_transaction_sequence:54,
_set_minimisation_constraints:219, _get_concrete_transaction:187,
_replace_with_actual_sha:131).

Produces the `initialState` + `steps` dict printed in reports, with calldatasize /
call-value minimization via the Optimize backend and keccak back-substitution so
witness calldata contains real hashes.

The port's copy of mythril_tpu/analysis/solver.py."""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from ..core.function_managers import keccak_function_manager
from ..utils.keccak import keccak256
from ..core.state.world_state import WorldState
from ..core.transaction.transaction_models import (BaseTransaction,
                                                   ContractCreationTransaction)
from ..core.transaction.symbolic import ACTORS
from ..exceptions import UnsatError
from ..smt import Bool, UGE, ULE, symbol_factory, terms
from ..support.model import get_model, prefetch_models

log = logging.getLogger(__name__)


def pretty_print_model(model) -> str:
    out = ""
    for item in model.decls():
        out += f"%s: %s\n" % (item.name, model.assignment[item])
    return out


def get_transaction_sequence(global_state, constraints) -> Dict:
    """Generate concrete transaction sequence satisfying `constraints`.

    Raises UnsatError if no valid transaction sequence exists."""
    transaction_sequence = global_state.world_state.transaction_sequence
    concrete_transactions: List[Dict] = []

    tx_constraints, minimize = _set_minimisation_constraints(
        transaction_sequence, list(constraints), [], 5000, global_state.world_state)

    # issue-confirmation prefetch (`--solver jax` + batching, no-op
    # otherwise): queue the base feasibility query together with the
    # Optimize extreme-probe ladder (every minimized objective pinned to 0
    # — the overwhelmingly common witness) so the whole confirmation
    # sequence solves as one device batch instead of a launch per probe
    speculative = [tuple(tx_constraints)]
    pinned = []
    for objective in minimize:
        raw = objective.raw if hasattr(objective, "raw") else objective
        pinned.append(Bool(terms.bv_cmp(
            "eq", raw, terms.bv_const(0, raw.width))))
        speculative.append(tuple(tx_constraints) + tuple(pinned))
    prefetch_models(speculative)

    try:
        model = get_model(tuple(tx_constraints), minimize=tuple(minimize))
    except UnsatError:
        raise

    # initial balances of involved accounts under the model
    initial_accounts = {}
    for address, account in global_state.world_state.accounts.items():
        try:
            balance_value = model.eval(
                global_state.world_state.starting_balances[account.address])
        except Exception:
            balance_value = 0
        initial_accounts["0x{:040x}".format(address)] = {
            "nonce": account.nonce,
            "code": "0x" + account.serialised_code(),
            "storage": {},
            "balance": hex(balance_value),
        }

    for transaction in transaction_sequence:
        concrete_transactions.append(
            _get_concrete_transaction(model, transaction))
    _replace_with_actual_sha(concrete_transactions, model)

    steps = {"initialState": {"accounts": initial_accounts},
             "steps": concrete_transactions}
    return steps


def _replace_with_actual_sha(concrete_transactions: List[Dict], model) -> None:
    """Patch solver-chosen hash values in witness calldata with real keccaks
    (reference analysis/solver.py:131).

    The owned solver picks a value for each symbolic keccak application that
    satisfies the interval axioms but is not the real digest; wherever that
    placeholder word appears in the witness calldata, substitute
    keccak256(model(input)) so replaying the witness on a real EVM matches."""
    substitutions: Dict[str, str] = {}
    for hash_expr, input_expr in keccak_function_manager.quick_inverse.items():
        # completion OFF: when the word-level simplifier eliminates a keccak
        # application from the final query, neither the hash nor its input is
        # constrained in the model — completion would evaluate both to 0 and
        # the all-zeros "placeholder" would string-replace every run of
        # zero-padding in the calldata
        try:
            placeholder_value = model.eval(hash_expr, model_completion=False)
            input_value = model.eval(input_expr, model_completion=False)
        except Exception:
            continue
        if placeholder_value is None or input_value is None:
            continue
        width = input_expr.size()
        real = int.from_bytes(
            keccak256(input_value.to_bytes(width // 8, "big")), "big")
        if real == placeholder_value:
            continue
        substitutions["{:064x}".format(placeholder_value)] = \
            "{:064x}".format(real)
    if not substitutions:
        return
    for transaction in concrete_transactions:
        input_hex = transaction["input"][2:]
        for placeholder, real_hex in substitutions.items():
            input_hex = input_hex.replace(placeholder, real_hex)
        transaction["input"] = "0x" + input_hex
        transaction["calldata"] = transaction["input"]


def _get_concrete_transaction(model, transaction: BaseTransaction) -> Dict:
    """Concretize one transaction under the model (reference solver.py:187)."""
    if isinstance(transaction, ContractCreationTransaction):
        code = transaction.code.bytecode if transaction.code else ""
        # constructor ARGUMENTS follow the code (reference solver.py:195-204
        # appends call_data.concrete(model)); the symbolic creation calldata
        # models args at offset 0
        try:
            arg_bytes = transaction.call_data.concrete(model)
        except (AttributeError, TypeError) as error:
            log.warning(
                "constructor-argument concretization failed (%s: %s); "
                "emitting creation witness without args — it may not "
                "reproduce", type(error).__name__, error)
            arg_bytes = []
        args_hex = "".join("{:02x}".format(b if isinstance(b, int) else 0)
                           for b in (arg_bytes or [])[:0x200])
        code = code + args_hex
        return {
            "address": "",
            "input": "0x" + code,
            "origin": _concrete_address(model, transaction.caller),
            "name": "unknown",
            "value": hex(_eval(model, transaction.call_value)),
            "gasLimit": hex(transaction.gas_limit or 8000000),
            "gasPrice": hex(_eval(model, transaction.gas_price)),
            "calldata": "0x" + code,
        }
    calldata = bytes(transaction.call_data.concrete(model))
    address = transaction.callee_account.address
    return {
        "address": "0x{:040x}".format(address.raw.value)
        if address.raw.is_const else str(address),
        "input": "0x" + calldata.hex(),
        "origin": _concrete_address(model, transaction.caller),
        "name": "unknown",
        "value": hex(_eval(model, transaction.call_value)),
        "gasLimit": hex(transaction.gas_limit or 8000000),
        "gasPrice": hex(_eval(model, transaction.gas_price)),
        "calldata": "0x" + calldata.hex(),
    }


def _eval(model, expression) -> int:
    try:
        return model.eval(expression)
    except Exception:
        return 0


def _concrete_address(model, address_expression) -> str:
    value = _eval(model, address_expression)
    return "0x{:040x}".format(value)


def _set_minimisation_constraints(transaction_sequence, constraints, minimize,
                                  max_size: int, world_state: WorldState):
    """Bound balances, prefer short calldata and small call values
    (reference solver.py:219)."""
    for transaction in transaction_sequence:
        if isinstance(transaction, ContractCreationTransaction):
            # creation calldatasize is PINNED to code + 0x200 arg space by
            # codesize_ (instructions.py) — bounding it to max_size would
            # make every witness query unsat for creation code > ~4.5 KB
            minimize.append(transaction.call_value)
            continue
        # bound calldata size so witnesses stay printable
        constraints.append(
            ULE(transaction.call_data.calldatasize,
                symbol_factory.BitVecVal(max_size, 256)))
        minimize.append(transaction.call_data.calldatasize)
        minimize.append(transaction.call_value)
    # attacker's starting balance is bounded (no magic riches)
    constraints.append(
        ULE(world_state.starting_balances[ACTORS.attacker],
            symbol_factory.BitVecVal(10 ** 20, 256)))
    return constraints, minimize
