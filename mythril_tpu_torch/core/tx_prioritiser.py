"""ML transaction prioritizer (capability parity:
mythril/laser/ethereum/tx_prioritiser/rf_prioritiser.py:11 RfTxPrioritiser).

Predicts which function sequence is most likely to reach a vulnerability and
drives non-incremental transaction exploration (`--incremental-txs False`,
LaserEVM.tx_strategy). A pickled sklearn RandomForest can be supplied via
`model_path`; without one, a deterministic risk-ranking model scores each
function from its extracted features (frontends/features.py) — dangerous
sinks first (selfdestruct, delegatecall, call), then payable/unguarded
functions — so the prioritizer works out of the box with no training data.

The port's copy of mythril_tpu/core/tx_prioritiser.py."""

from __future__ import annotations

import logging
import pickle
from typing import Dict, List, Optional

import numpy as np

log = logging.getLogger(__name__)

#: feature order inside each function's flattened vector
FEATURE_KEYS = [
    "contains_selfdestruct", "contains_call", "is_payable",
    "has_owner_modifier", "contains_assert", "contains_callcode",
    "contains_delegatecall", "contains_staticcall",
]

#: risk weight per feature for the built-in heuristic model
RISK_WEIGHTS = {
    "contains_selfdestruct": 8.0,
    "contains_delegatecall": 6.0,
    "contains_callcode": 6.0,
    "contains_call": 4.0,
    "is_payable": 2.0,
    "contains_staticcall": 1.0,
    "contains_assert": 1.0,
    "has_owner_modifier": -3.0,  # owner-gated functions are less reachable
}


class HeuristicRiskModel:
    """Drop-in for a sklearn classifier: predict_proba over function indices.

    Score = static per-function risk, with a repetition penalty for functions
    predicted recently (the tail of the feature vector carries the recent
    prediction history, mirroring the RF model's input layout)."""

    def __init__(self, n_functions: int, per_function: int):
        self.n_functions = n_functions
        self.per_function = per_function

    def predict_proba(self, features: np.ndarray) -> np.ndarray:
        flat = features[0]
        static = flat[:self.n_functions * self.per_function]
        history = flat[self.n_functions * self.per_function:]
        scores = np.zeros(self.n_functions)
        for index in range(self.n_functions):
            row = static[index * self.per_function:
                         (index + 1) * self.per_function]
            for key_index, key in enumerate(FEATURE_KEYS):
                scores[index] += RISK_WEIGHTS[key] * float(row[key_index])
        for predicted in history:
            if 0 <= int(predicted) < self.n_functions:
                scores[int(predicted)] -= 1.5  # vary the sequence
        exp = np.exp(scores - scores.max())
        return (exp / exp.sum()).reshape(1, -1)


class RfTxPrioritiser:
    """Same protocol as the reference: `__next__(address)` yields the next
    predicted function-index sequence of length `depth`."""

    def __init__(self, contract, depth: int = 3,
                 model_path: Optional[str] = None):
        self.contract = contract
        self.depth = depth
        self.recent_predictions: List[int] = []
        features: Optional[Dict[str, Dict]] = getattr(contract, "features",
                                                      None)
        if not features:
            log.info("no solidity features available: RF-based tx "
                     "prioritisation turned off")
            self.model = None
            self.function_names: List[str] = []
            return
        self.function_names = list(features.keys())
        self.preprocessed_features = self.preprocess_features(features)
        if model_path:
            with open(model_path, "rb") as handle:
                self.model = pickle.load(handle)
        else:
            self.model = HeuristicRiskModel(
                n_functions=len(self.function_names),
                per_function=len(FEATURE_KEYS))

    def preprocess_features(self, features_dict: Dict[str, Dict]) -> np.ndarray:
        flat: List[float] = []
        for function_features in features_dict.values():
            for key in FEATURE_KEYS:
                flat.append(float(bool(function_features.get(key))))
        return np.array(flat).reshape(1, -1)

    def __next__(self, address=None) -> List[int]:
        if self.model is None:
            return []
        predictions_sequence: List[int] = []
        for _ in range(self.depth):
            current = np.concatenate(
                [self.preprocessed_features,
                 np.array(self.recent_predictions + predictions_sequence,
                          dtype=float).reshape(1, -1)],
                axis=1)
            probabilities = self.model.predict_proba(current)
            predictions_sequence.append(int(np.argmax(probabilities, axis=1)[0]))
        self.recent_predictions.extend(predictions_sequence)
        while len(self.recent_predictions) > self.depth:
            self.recent_predictions.pop(0)
        return predictions_sequence
