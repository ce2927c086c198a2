"""The port's copy of mythril_tpu/core/transaction/__init__.py."""

from .transaction_models import (
    BaseTransaction, ContractCreationTransaction, MessageCallTransaction,
    TransactionEndSignal, TransactionStartSignal, tx_id_manager,
    get_next_transaction_id,
)
from .symbolic import (ACTORS, Actors, execute_contract_creation,
                       execute_message_call)

__all__ = [
    "BaseTransaction", "ContractCreationTransaction", "MessageCallTransaction",
    "TransactionEndSignal", "TransactionStartSignal", "tx_id_manager",
    "get_next_transaction_id", "ACTORS", "Actors", "execute_contract_creation",
    "execute_message_call",
]
