"""K2's operand and its in-place, strided launches (ops/rs.py,
ops/rs_kernel.py) through the plain version: the cached operand against
the JAX package's bit matrix, the two launches that extend a square inside
the EDS against the Pallas and XLA extensions, the wrapper's refusals, and
extend_square_fn's schedule (two launches, no copies, one operand)."""

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


def _extend_in_place(ods: np.ndarray) -> torch.Tensor:
    """The two launches of the square extension, run by hand on an EDS
    whose other quadrants start as garbage."""
    k = ods.shape[0]
    eds = torch.from_numpy(np.random.default_rng(99).integers(0, 256, (2 * k, 2 * k, 512), dtype=np.uint8))
    eds[:k, :k] = torch.from_numpy(ods)
    operand = rs.bit_operand(k, "cpu")
    rs_kernel.extend_eds(eds, "rows_cols", operand)
    rs_kernel.extend_eds(eds, "q3", operand)
    return eds


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64, 128])
def test_bit_operand_is_the_reference_matrix_padded_and_cached(k):
    operand = rs.bit_operand(k, "cpu")
    side = rs_kernel.padded(k)
    assert operand.dtype == torch.uint8 and operand.shape == (side, side)
    assert operand.is_contiguous() and operand.device.type == "cpu"
    assert set(torch.unique(operand).tolist()) <= {0, 1}
    assert operand[: 8 * k, : 8 * k].numpy().tobytes() == jax_leopard.bit_matrix(k).astype(np.uint8).tobytes()
    assert not operand[8 * k:].any() and not operand[:, 8 * k:].any()
    assert rs.bit_operand(k, "cpu") is operand
    assert rs.bit_operand(k, torch.device("cpu")) is operand


@pytest.mark.parametrize("k", [4, 8])
def test_in_place_extend_matches_pallas_kernel_interpret_mode(k):
    ods = _ods(k, 30 + k)
    ref = np.asarray(rs_pallas.extend_square_fn(k, interpret=True)(ods))
    eds = _extend_in_place(ods).numpy()
    np.testing.assert_array_equal(eds[:k, k:], ref[:k, k:])
    np.testing.assert_array_equal(eds[k:, :k], ref[k:, :k])
    np.testing.assert_array_equal(eds[k:, k:], ref[k:, k:])


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_in_place_extend_matches_xla_batched_int8(k):
    ods = _ods(k, 40 + k)
    ref = np.asarray(jax.jit(jax_rs.extend_square_fn(k, layout="batched", dtype="int8"))(ods))
    np.testing.assert_array_equal(_extend_in_place(ods).numpy(), ref)


@pytest.mark.parametrize("k", [2, 8])
def test_extend_lines_takes_strided_lines_like_contiguous_ones(k):
    """A column group read in place, written transposed into a fresh
    tensor, equals the pass over the transposed square made contiguous."""
    x = torch.from_numpy(_ods(k, 50 + k))
    operand = rs.bit_operand(k, "cpu")
    out = torch.zeros((k, k, 512), dtype=torch.uint8)
    rs_kernel.extend_lines(((x.transpose(0, 1), out.transpose(0, 1)),), operand)
    want = rs_kernel.extend_pass(x.transpose(0, 1).contiguous(), operand).transpose(0, 1)
    assert torch.equal(out, want)


def _eds(k=4, dtype=torch.uint8, device="cpu"):
    return torch.zeros((2 * k, 2 * k, 512), dtype=dtype, device=device)


_E = _eds()
_F = _eds()


@pytest.mark.parametrize(
    "groups",
    [
        # bad strides: share bytes not contiguous, strides not multiples of 512, zero strides
        ((_E[:4, :4, ::2], _E[:4, 4:, ::2]),),
        ((_E.view(-1)[256:256 + 4 * 4 * 512].view(4, 4, 512), _F[:4, :4]),),
        ((_E[:4, :4], _E.view(-1)[8:8 + 8192].view(4, 4, 512)),),
        ((_E[:1, :4].expand(4, 4, 512), _F[:4, :4]),),
        # a destination that overlaps its source, itself, or another group's lines
        ((_E[:4, :4], _E[:4, :4]),),
        ((_E[:4, :4], _E[:4, 1:5]),),
        ((_E[:4, :4], _F.as_strided((4, 4, 512), (512, 512, 1))),),
        ((_E[:4, :4], _E[:4, 4:]), (_E[:4, 4:].transpose(0, 1), _F[4:, :4])),
        ((_E[:4, :4], _E[:4, 4:]), (_F[:4, :4], _E[:4, 4:])),
        # shapes: k mismatch between groups, source and destination, too many groups, non power of two
        ((_E[:4, :4], _E[:4, 4:]), (_F[:2, :2], _F[:2, 2:4])),
        ((_E[:4, :4], _F[:4, :2]),),
        ((_E[:1, :4], _E[1:2, 4:]), (_E[2:3, :4], _E[2:3, 4:]), (_E[3:4, :4], _E[3:4, 4:])),
        ((_E[:3, :3], _E[:3, 4:7]),),
        # dtypes and devices
        ((_eds(dtype=torch.int32)[:4, :4], _eds(dtype=torch.int32)[:4, 4:]),),
        ((_E[:4, :4], _eds(device="meta")[:4, 4:]),),
        ((_eds(device="meta")[:4, :4], _eds(device="meta")[:4, 4:]),),
    ],
)
def test_extend_lines_rejects_what_the_kernel_does_not_take(groups):
    with pytest.raises(ValueError):
        rs_kernel.extend_lines(groups, rs.bit_operand(4, "cpu"))


@pytest.mark.parametrize(
    "operand",
    [torch.zeros((128, 128), dtype=torch.int8), torch.zeros((64, 64), dtype=torch.uint8),
     torch.zeros((128, 256), dtype=torch.uint8)[:, ::2], torch.zeros((128, 128), dtype=torch.uint8, device="meta")],
)
def test_extend_lines_rejects_a_bad_operand(operand):
    eds = _eds()
    with pytest.raises(ValueError):
        rs_kernel.extend_eds(eds, "rows_cols", operand)


@pytest.mark.parametrize(
    "eds,launch",
    [(_eds(), "cols"), (_eds()[:, :4], "q3"), (torch.zeros((8, 6, 512), dtype=torch.uint8), "q3"),
     (_eds().transpose(0, 1), "rows_cols"), (_eds(dtype=torch.int16), "q3")],
)
def test_extend_eds_rejects_a_bad_square_or_launch(eds, launch):
    with pytest.raises(ValueError):
        rs_kernel.extend_eds(eds, launch, rs.bit_operand(4, "cpu"))


def test_extend_square_fn_makes_two_in_place_launches_no_copies_one_operand(monkeypatch):
    k = 8
    rs._operand.cache_clear()
    built = []
    real_bit_matrix = leopard.bit_matrix
    monkeypatch.setattr(leopard, "bit_matrix", lambda n: built.append(n) or real_bit_matrix(n))
    launches = []
    real_extend_lines = rs_kernel.extend_lines

    def recording(groups, operand):
        launches.append(tuple(groups))
        real_extend_lines(groups, operand)

    monkeypatch.setattr(rs_kernel, "extend_lines", recording)

    def copying(*args, **kwargs):
        raise AssertionError("the extension concatenates or makes a transpose contiguous")

    monkeypatch.setattr(torch, "cat", copying)
    monkeypatch.setattr(torch.Tensor, "contiguous", copying)
    ods = _ods(k, 60)
    outs = [rs.extend_square_fn(k, "cpu")(torch.from_numpy(ods)) for _ in range(2)]
    assert built == [k]  # the operand was built once for both squares
    assert len(launches) == 4  # two per square
    for eds, (first, second) in zip(outs, (launches[:2], launches[2:])):
        assert [len(g) for g in (first, second)] == [2, 1]
        for group in first + second:
            for view in group:
                assert view.untyped_storage().data_ptr() == eds.untyped_storage().data_ptr()
        assert first[0][1].data_ptr() == eds[:k, k:].data_ptr()  # Q1
        assert first[1][0].stride() == (512, 2 * k * 512, 1)  # columns of Q0, read in place
        assert second[0][1].data_ptr() == eds[k:, k:].data_ptr()  # Q3
    monkeypatch.undo()
    ref = np.asarray(jax.jit(jax_rs.extend_square_fn(k, layout="batched", dtype="int8"))(ods))
    for eds in outs:
        np.testing.assert_array_equal(eds.numpy(), ref)
