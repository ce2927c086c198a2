"""Find the port's index writes whose result depends on write order.

A torch index write (`t[idx] = v`, `index_put_`, `scatter_`) that puts two
different values in one cell keeps whichever its CPU threads or CUDA
blocks write last. `conflicting_writes()` patches the three writes while a
block runs and records, for each write made from mythril_tpu_torch whose
positions repeat with different values, the calling function, the
tensor's shape and whether every such cell is a drop slot (the last index
of the last dimension, where the port sends masked writes and which it
never reads)."""

import contextlib
import traceback

import torch


def _caller():
    for frame in reversed(traceback.extract_stack()[:-3]):
        if "mythril_tpu_torch" in frame.filename:
            return f"{frame.filename.rsplit('mythril_tpu_torch/', 1)[-1]}:" \
                   f"{frame.name}"
    return None


def _conflicts(positions, values):
    """The cells of `positions` written twice with different `values`."""
    flat = positions.reshape(-1)
    vals = values.reshape(-1)
    order = torch.argsort(flat, stable=True)
    cells, vals = flat[order], vals[order]
    differ = (cells[1:] == cells[:-1]) & (vals[1:] != vals[:-1])
    return torch.unique(cells[1:][differ])


@contextlib.contextmanager
def conflicting_writes():
    """Yields {"writes": n, "conflicts": [...]}: the index writes the
    port made inside the block, and (caller, shape, all drop slots, cells)
    for every order-dependent one."""
    found, busy = {"writes": 0, "conflicts": []}, [False]
    setitem = torch.Tensor.__setitem__
    scatter_ = torch.Tensor.scatter_
    index_put_ = torch.Tensor.index_put_

    def record(tensor, positions, values):
        caller = _caller()
        if caller is None:
            return
        found["writes"] += 1
        if positions.numel() < 2:
            return
        cells = _conflicts(positions, values)
        if cells.numel():
            last = tensor.shape[-1]
            found["conflicts"].append((
                caller, tuple(tensor.shape),
                bool(((cells % last) == last - 1).all()),
                int(cells.numel())))

    def positions_of(tensor):
        return torch.arange(tensor.numel()).view(tensor.shape)

    def patched_setitem(self, key, value):
        if not busy[0] and torch.is_tensor(value) and self.numel() > 1:
            busy[0] = True
            try:
                positions = positions_of(self)[key]
                record(self, positions,
                       torch.broadcast_to(value, positions.shape))
            except (IndexError, RuntimeError, TypeError):
                pass  # a write the position map cannot mirror: not indexed
            finally:
                busy[0] = False
        return setitem(self, key, value)

    def patched_scatter_(self, dim, index, src=None, **kwargs):
        if not busy[0] and torch.is_tensor(src):
            busy[0] = True
            try:
                record(self, positions_of(self).gather(dim, index),
                       src[tuple(slice(0, n) for n in index.shape)])
            finally:
                busy[0] = False
        if src is None:
            return scatter_(self, dim, index, **kwargs)
        return scatter_(self, dim, index, src, **kwargs)

    def patched_index_put_(self, indices, values, accumulate=False):
        if not accumulate and not busy[0]:
            busy[0] = True
            try:
                positions = positions_of(self)[tuple(indices)]
                record(self, positions,
                       torch.broadcast_to(values, positions.shape))
            finally:
                busy[0] = False
        return index_put_(self, indices, values, accumulate)

    torch.Tensor.__setitem__ = patched_setitem
    torch.Tensor.scatter_ = patched_scatter_
    torch.Tensor.index_put_ = patched_index_put_
    try:
        yield found
    finally:
        torch.Tensor.__setitem__ = setitem
        torch.Tensor.scatter_ = scatter_
        torch.Tensor.index_put_ = index_put_
