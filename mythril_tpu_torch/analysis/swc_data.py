"""SWC registry id <-> title table (capability parity: mythril/analysis/swc_data.py).

The port's copy of mythril_tpu/analysis/swc_data.py."""

DELEGATECALL_TO_UNTRUSTED_CONTRACT = "112"
PRECOMPILED_CONTRACT_WRONG_INPUT = "127"
TX_ORIGIN_USAGE = "115"
UNCHECKED_RET_VAL = "104"
UNPROTECTED_ETHER_WITHDRAWAL = "105"
UNPROTECTED_SELFDESTRUCT = "106"
REENTRANCY = "107"
MULTIPLE_SENDS = "113"
TX_ORDER_DEPENDENCE = "114"
ASSERT_VIOLATION = "110"
DEPRECATED_FUNCTIONS_USAGE = "111"
INTEGER_OVERFLOW_AND_UNDERFLOW = "101"
TIMESTAMP_DEPENDENCE = "116"
WEAK_RANDOMNESS = "120"
REQUIREMENT_VIOLATION = "123"
WRITE_TO_ARBITRARY_STORAGE = "124"
ARBITRARY_JUMP = "127"
UNEXPECTED_ETHER_BALANCE = "132"

SWC_TO_TITLE = {
    "100": "Function Default Visibility",
    "101": "Integer Overflow and Underflow",
    "102": "Outdated Compiler Version",
    "103": "Floating Pragma",
    "104": "Unchecked Call Return Value",
    "105": "Unprotected Ether Withdrawal",
    "106": "Unprotected SELFDESTRUCT Instruction",
    "107": "Reentrancy",
    "108": "State Variable Default Visibility",
    "109": "Uninitialized Storage Pointer",
    "110": "Assert Violation",
    "111": "Use of Deprecated Solidity Functions",
    "112": "Delegatecall to Untrusted Callee",
    "113": "DoS with Failed Call",
    "114": "Transaction Order Dependence",
    "115": "Authorization through tx.origin",
    "116": "Block values as a proxy for time",
    "120": "Weak Sources of Randomness from Chain Attributes",
    "123": "Requirement Violation",
    "124": "Write to Arbitrary Storage Location",
    "127": "Arbitrary Jump with Function Type Variable",
    "132": "Unexpected Ether balance",
}
