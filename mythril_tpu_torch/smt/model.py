"""Model (witness) object (API parity: mythril/laser/smt/model.py:6).

A Model is a total assignment completion: variables the solver never saw evaluate to
zero, matching the model-completion behavior the reference relies on
(model.eval(..., model_completion=True)).

The port's copy of mythril_tpu/smt/model.py, unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import terms
from .expression import Expression


class Model:
    def __init__(self,
                 assignment: Optional[Dict[terms.Term, int]] = None,
                 arrays: Optional[Dict[terms.Term, dict]] = None,
                 ufs: Optional[Dict[tuple, int]] = None):
        #: var term -> int (BV) / bool
        self.assignment: Dict[terms.Term, int] = dict(assignment or {})
        #: base array var term -> {index_int: value_int, "default": int}
        self.arrays: Dict[terms.Term, dict] = {k: dict(v) for k, v in (arrays or {}).items()}
        #: (uf_name, (arg_ints,)) -> int
        self.ufs: Dict[tuple, int] = dict(ufs or {})

    def merge(self, other: "Model") -> "Model":
        merged = Model(self.assignment, self.arrays, self.ufs)
        # explicit key loop: lazy assignments (incremental._BitsAssignment)
        # expose their full domain via keys(), which dict.update would bypass
        for key in list(other.assignment.keys()):
            try:
                merged.assignment[key] = other.assignment[key]
            except KeyError:
                continue
        for base, table in other.arrays.items():
            merged.arrays.setdefault(base, {}).update(table)
        merged.ufs.update(other.ufs)
        return merged

    def eval(self, expression, model_completion: bool = True):
        """Evaluate an Expression (or raw Term) to a concrete int/bool."""
        raw = expression.raw if isinstance(expression, Expression) else expression
        lookup = _CompletionDict(self, model_completion)
        try:
            return terms.evaluate(raw, lookup)
        except KeyError:
            if model_completion:
                raise  # completion already defaults: a KeyError here is a real bug
            return None

    def decls(self):
        return list(self.assignment.keys())

    def __getitem__(self, item):
        return self.eval(item)


class _CompletionDict(dict):
    """Assignment view: completes missing vars with zeros/empty tables."""

    def __init__(self, model: Model, complete: bool):
        super().__init__()
        self._model = model
        self._complete = complete
        self["__uf__"] = _UfView(model, complete)

    def __missing__(self, key):
        if key == "__uf__":
            raise KeyError(key)
        model = self._model
        if key in model.assignment:
            return model.assignment[key]
        if key in model.arrays:
            table = dict(model.arrays[key])
            table.setdefault("default", 0)
            return table
        if not self._complete:
            raise KeyError(key)
        if isinstance(key.sort, terms.ArraySort):
            return {"default": 0}
        if key.sort == terms.BOOL:
            return False
        return 0


class _UfView(dict):
    def __init__(self, model: Model, complete: bool):
        super().__init__()
        self._model = model
        self._complete = complete

    def __contains__(self, key):
        return key in self._model.ufs or self._complete

    def __getitem__(self, key):
        if key in self._model.ufs:
            return self._model.ufs[key]
        if self._complete:
            return 0
        raise KeyError(key)
