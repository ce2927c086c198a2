"""The port's batched keccak-256 twin against the JAX `keccak256` and the
pure-Python digest: known vectors and every padding boundary."""

import jax.numpy as jnp
import numpy as np
import torch

import mythril_tpu.parallel  # noqa: F401  (x64 on)
from mythril_tpu.parallel import keccak as jk
from mythril_tpu_torch.parallel import keccak as tk
from mythril_tpu_torch.utils.keccak import keccak256_py

VECTORS = {
    b"": "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470",
    b"abc": "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45",
    b"transfer(address,uint256)":
        "a9059cbb2ab09eb219583f4a59a5d0623ade346d962bcd4e46b11da047c9049b",
}
LENGTHS = [0, 1, 55, 134, 135, 136, 137, 271, 272, 273, 400, 511, 512]


def test_known_vectors():
    data = np.zeros((len(VECTORS), 512), dtype=np.uint8)
    lengths = []
    for i, preimage in enumerate(VECTORS):
        data[i, :len(preimage)] = np.frombuffer(preimage, dtype=np.uint8)
        lengths.append(len(preimage))
    got = tk.keccak256(torch.from_numpy(data),
                       torch.tensor(lengths, dtype=torch.int32))
    assert [bytes(row.tolist()).hex() for row in got] == list(VECTORS.values())


def test_padding_boundaries_match_jax_and_python():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (len(LENGTHS), 512), dtype=np.uint8)
    lengths = np.asarray(LENGTHS, dtype=np.int32)
    got = tk.keccak256(torch.from_numpy(data), torch.from_numpy(lengths))
    ref = np.asarray(jk.keccak256(jnp.asarray(data), jnp.asarray(lengths)))
    np.testing.assert_array_equal(got.numpy(), ref)
    for i, n in enumerate(LENGTHS):
        assert bytes(got[i].tolist()) == keccak256_py(bytes(data[i, :n]))


def test_bytes_past_length_are_ignored():
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (4, 300), dtype=np.uint8)
    lengths = torch.tensor([0, 136, 137, 299], dtype=torch.int32)
    first = tk.keccak256(torch.from_numpy(data), lengths)
    data[:, 299:] ^= 0xFF
    data[0] ^= 0x5A
    again = tk.keccak256(torch.from_numpy(data), lengths)
    assert torch.equal(first[:3], again[:3])
