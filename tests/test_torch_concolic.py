"""The port's concolic driver (mythril_tpu_torch/concolic/) against the JAX
package's (mythril_tpu/concolic/), on the host engine of each.

- `concrete_execution` on two ConcreteData inputs: one message call with
  32 zero bytes of calldata to a 12-instruction contract that stores 1 when
  its calldata word is 0x2a (JUMPI at 9), and a contract creation followed
  by a call with 0x2a: each package's trace (pc, transaction id) and its
  initial world state's accounts are equal.
- `validate_concrete_data`'s errors are equal.
- `concolic_execution` asked to flip the JUMPI at 9 raises the same
  AttributeError in both packages, under `engine="oracle"` and
  `"lockstep"`: ConcolicStrategy annotates a state with a TraceAnnotation,
  which is not a StateAnnotation, and GlobalState.annotate reads its
  `persist_to_world_state` (ROADMAP C, the concolic entry). The port
  keeps the fault for parity.

Every run starts from both packages' counters reset (tests/_torch_engine.py
`run_on`)."""

import copy

import pytest

from _torch_engine import PORT, run_both
from mythril_tpu.concolic import concolic_execution as jconcolic_execution
from mythril_tpu.concolic import concrete_data as jconcrete_data
from mythril_tpu.concolic import find_trace as jfind_trace
from mythril_tpu_torch.concolic import concolic_execution as pconcolic_execution
from mythril_tpu_torch.concolic import concrete_data as pconcrete_data
from mythril_tpu_torch.concolic import find_trace as pfind_trace

#: each package's find_trace module, concolic_execution function (the
#: package exports the function under its module's name) and concrete_data
CONCOLIC = {"jax": (jfind_trace, jconcolic_execution, jconcrete_data),
            "port": (pfind_trace, pconcolic_execution, pconcrete_data)}

#: stores 1 at slot 0 when the first calldata word is 0x2a; the JUMPI is at 9
GUARDED = ("PUSH1 0x00\nCALLDATALOAD\nPUSH1 0x2a\nEQ\nPUSH @yes\nJUMPI\nSTOP\n"
           "yes:\nJUMPDEST\nPUSH1 0x01\nPUSH1 0x00\nSSTORE\nSTOP")
JUMPI = 9
TARGET = "0x" + "af" * 20
ORIGIN = "0x" + "ca" * 20


def step(address: str, data: str) -> dict:
    return {"address": address, "input": data, "origin": ORIGIN,
            "value": "0x0", "gasLimit": "0x7a1200", "gasPrice": "0x0"}


def concrete_data(name: str) -> dict:
    runtime = PORT.asm.assemble(GUARDED)
    accounts = {TARGET: {"nonce": 0, "code": "0x" + runtime.hex(),
                         "storage": {"0x1": "0x5"}, "balance": "0x10"}}
    steps = [step(TARGET, "0x" + "00" * 32)]
    if name == "creation":
        creation = PORT.asm.creation_wrapper(runtime).hex()
        steps = [step("", "0x" + creation),
                 step(TARGET, "0x" + "00" * 31 + "2a")]
    return {"initialState": {"accounts": accounts}, "steps": steps}


@pytest.mark.parametrize("name", ["call", "creation"])
def test_concrete_execution_equals_the_jax_trace(name):
    def case(side):
        find_trace = CONCOLIC[side.name][0]
        init_state, trace = find_trace.concrete_execution(
            concrete_data(name))
        accounts = {address: account.as_dict
                    for address, account in init_state.accounts.items()}
        return trace, accounts

    observed = run_both(case)
    assert observed["port"] == observed["jax"]
    trace, accounts = observed["port"]
    executed = [entry for tx_trace in trace for entry in tx_trace]
    assert (JUMPI, executed[-1][1]) in executed
    assert len({tx for _, tx in executed}) == len(
        concrete_data(name)["steps"])
    assert accounts[int(TARGET, 16)]["nonce"] == 0


#: ConcreteData missing one field each
INVALID = {
    "no_steps": {"initialState": {"accounts": {}}},
    "no_initial_state": {"steps": []},
    "no_accounts": {"initialState": {}, "steps": []},
    "step_without_input": {"initialState": {"accounts": {}},
                           "steps": [{"address": TARGET}]},
}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_validation_errors_equal(name):
    errors = {}
    for side in ("jax", "port"):
        with pytest.raises(ValueError) as raised:
            CONCOLIC[side][2].validate_concrete_data(
                copy.deepcopy(INVALID[name]))
        errors[side] = str(raised.value)
    assert errors["port"] == errors["jax"]
    CONCOLIC["port"][2].validate_concrete_data(concrete_data("call"))


@pytest.mark.parametrize("engine", ["oracle", "lockstep"])
def test_flipping_raises_as_the_jax_package(engine):
    def case(side):
        with pytest.raises(AttributeError) as raised:
            CONCOLIC[side.name][1](concrete_data("call"), [JUMPI],
                                   engine=engine)
        return str(raised.value), raised.traceback[-1].name

    observed = run_both(case)
    assert observed["port"] == observed["jax"]
    message, where = observed["port"]
    assert message == ("'TraceAnnotation' object has no attribute "
                       "'persist_to_world_state'")
    assert where == "annotate"
