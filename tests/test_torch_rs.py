"""Port RS extension (ops/rs.py, kernel K2's plain version) against the JAX
package: the bit matrix and K2's operand, each pass and the whole extended
square, byte for byte."""

import jax
import numpy as np
import pytest
import torch

from celestia_app_tpu.ops import leopard as jax_leopard
from celestia_app_tpu.ops import rs as jax_rs
from celestia_app_tpu.ops import rs_pallas
from celestia_app_tpu_torch.ops import leopard, rs, rs_kernel


def _ods(k: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (k, k, 512), dtype=np.uint8)


def _passes(ods: np.ndarray, operand: torch.Tensor):
    """Q1, Q2, Q3 through the plain pass: rows of Q0, columns of Q0, rows of Q2."""
    x = torch.from_numpy(ods)
    q1 = rs_kernel.extend_pass_ref(x, operand)
    q2 = rs_kernel.extend_pass_ref(x.transpose(0, 1), operand).transpose(0, 1)
    q3 = rs_kernel.extend_pass_ref(q2, operand)
    return q1.numpy(), q2.numpy(), q3.numpy()


def _check_against(ref: np.ndarray, ods: np.ndarray):
    k = ods.shape[0]
    operand = rs.operand_from_bit_matrix(leopard.bit_matrix(k), "cpu")
    q1, q2, q3 = _passes(ods, operand)
    np.testing.assert_array_equal(q1, ref[:k, k:])
    np.testing.assert_array_equal(q2, ref[k:, :k])
    np.testing.assert_array_equal(q3, ref[k:, k:])
    got = rs.extend_square_fn(k, "cpu")(torch.from_numpy(ods)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64, 128])
def test_bit_matrix_equals_reference(k):
    mine, ref = leopard.bit_matrix(k), jax_leopard.bit_matrix(k)
    assert mine.dtype == ref.dtype and mine.shape == (8 * k, 8 * k)
    assert mine.tobytes() == ref.tobytes()


@pytest.mark.parametrize("k", [4, 8])
def test_matches_pallas_kernel_interpret_mode(k):
    ods = _ods(k, 3)
    ref = np.asarray(rs_pallas.extend_square_fn(k, interpret=True)(ods))
    _check_against(ref, ods)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_matches_xla_batched_int8(k):
    ods = _ods(k, 10 + k)
    ref = np.asarray(jax.jit(jax_rs.extend_square_fn(k, layout="batched", dtype="int8"))(ods))
    _check_against(ref, ods)


@pytest.mark.parametrize("k", [2, 8, 16])
def test_reference_bit_matrix_gives_the_same_square(k):
    """The constant carried across: the port fed the JAX package's matrix
    extends exactly as it does with its own."""
    ods = torch.from_numpy(_ods(k, 20 + k))
    theirs = rs.operand_from_bit_matrix(jax_leopard.bit_matrix(k), "cpu")
    ours = rs.operand_from_bit_matrix(leopard.bit_matrix(k), "cpu")
    assert torch.equal(theirs, ours)
    a = rs.extend_square_fn(k, "cpu", operand=theirs)(ods)
    b = rs.extend_square_fn(k, "cpu")(ods)
    assert torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 2, 4, 128])
def test_operand_holds_the_bit_matrix_zero_padded(k):
    mat = leopard.bit_matrix(k)
    operand = rs.operand_from_bit_matrix(mat, "cpu")
    side = rs_kernel.padded(k)
    assert operand.dtype == torch.uint8 and operand.shape == (side, side)
    assert side % rs_kernel.TILE == 0 and side >= 8 * k
    np.testing.assert_array_equal(operand[: 8 * k, : 8 * k].numpy().astype(np.int8), mat)
    assert not operand[8 * k:].any() and not operand[:, 8 * k:].any()


def test_bits_round_trip():
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (3, 4, 16), dtype=np.uint8))
    bits = rs_kernel.bytes_to_bits(x)
    assert bits.shape == (3, 32, 16)
    assert torch.equal(rs_kernel.bits_to_bytes(bits), x)


def test_gf16_square_sizes_raise():
    with pytest.raises(ValueError):
        rs.extend_square_fn(256, "cpu")


_OP4 = torch.zeros((128, 128), dtype=torch.uint8)  # the operand's shape at k = 4


@pytest.mark.parametrize(
    "x,operand",
    [
        (torch.zeros((4, 4, 256), dtype=torch.uint8), _OP4),
        (torch.zeros((3, 3, 512), dtype=torch.uint8), torch.zeros((128, 128), dtype=torch.uint8)),
        (torch.zeros((4, 4, 512), dtype=torch.int32), _OP4),
        (torch.zeros((4, 4, 512), dtype=torch.uint8), torch.zeros((32, 32), dtype=torch.uint8)),
        (torch.zeros((4, 4, 512), dtype=torch.uint8), torch.zeros((128, 128), dtype=torch.int8)),
        (torch.zeros((4, 4, 512), dtype=torch.uint8).transpose(0, 1), _OP4),
        (torch.zeros((4, 4, 512), dtype=torch.uint8), torch.zeros((128, 128), dtype=torch.uint8, device="meta")),
        (torch.zeros((4, 4, 512), dtype=torch.uint8, device="meta"), torch.zeros((128, 128), dtype=torch.uint8, device="meta")),
    ],
)
def test_extend_pass_rejects_what_the_kernel_does_not_take(x, operand):
    with pytest.raises(ValueError):
        rs_kernel.extend_pass(x, operand)


def test_extend_pass_on_cpu_takes_plain_version_without_launching():
    k = 4
    x = torch.from_numpy(_ods(k, 5))
    operand = rs.bit_operand(k, "cpu")
    before = rs_kernel.extend_lines.launches
    assert torch.equal(rs_kernel.extend_pass(x, operand), rs_kernel.extend_pass_ref(x, operand))
    assert rs_kernel.extend_lines.launches == before


@pytest.mark.parametrize("mat", [np.zeros((8, 16), np.int8), np.full((8, 8), 2, np.int8)])
def test_operand_from_bit_matrix_rejects_bad_matrices(mat):
    with pytest.raises(ValueError):
        rs.operand_from_bit_matrix(mat, "cpu")
