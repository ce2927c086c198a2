"""hevm/forge cheat-code VM addresses (capability parity:
mythril/laser/ethereum/cheat_code.py:23 hevm_cheat_code + handle_cheat_codes).

Foundry/ds-test contracts call the magic VM address for test plumbing
(vm.assume, expectRevert, the ds-test `failed` flag). Like the reference, the
call itself is modeled as an unconditional success (retval pinned to 1) so
test-harness scaffolding never blocks exploration of the contract under
test.

The port's copy of mythril_tpu/core/cheat_code.py."""

from __future__ import annotations

from typing import Union

from ..smt import BitVec
from .state.calldata import BaseCalldata
from .state.global_state import GlobalState


class hevm_cheat_code:
    # https://github.com/dapphub/ds-test: HEVM_ADDRESS and the console address
    address = 0x7109709ECFA91A80626FF3989D68F67F5B1DD12D
    console_address = 0x72C68108A82E82617B93D1BE0D7975D762035015

    #: store(HEVM_ADDRESS, "failed", 1) calldata — ds-test failure flag
    fail_payload = int(
        "70ca10bb"
        "0000000000000000000000007109709ecfa91a80626ff3989d68f67f5b1dd12d"
        "6661696c65640000000000000000000000000000000000000000000000000000"
        "0000000000000000000000000000000000000000000000000000000000000001",
        16,
    )

    #: vm.assume(bool) selector
    assume_sig = 0x4C63E562

    @staticmethod
    def is_cheat_address(address: Union[str, int]) -> bool:
        if isinstance(address, str):
            address = int(address, 16)
        return address in (hevm_cheat_code.address,
                           hevm_cheat_code.console_address)


def handle_cheat_codes(global_state: GlobalState,
                       callee_address: Union[str, BitVec],
                       call_data: BaseCalldata,
                       memory_out_offset, memory_out_size) -> None:
    """Model the cheat call as success: push retval constrained to 1
    (reference cheat_code.py:47-56)."""
    instruction = global_state.get_current_instruction()
    retval = global_state.new_bitvec(f"retval_{instruction['address']}", 256)
    global_state.mstate.stack.append(retval)
    global_state.world_state.constraints.append(retval == 1)
