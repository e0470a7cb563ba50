"""The nine probe windows of scripts/probe_mosaic_aot.py (P1-P9) in the
port (advise_tpu_torch/ops/window_probe.py): each probe's plain version
against a numpy statement of the probe's kernel body, line by line from
the script. On the CPU each probe entry takes its plain version; the CUDA
window gather is held equal to it on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

JAX cannot run the probes themselves here: they are closures inside the
script's main() and compile only against a TPU topology (the AOT harness
of the script), so the numpy statements stand in for them. pltpu.roll has
jnp.roll's semantics. Every comparison is exact: the probes move and cast
values, and P1 adds two float32 values, which rounds the same in any order.
"""

import numpy as np
import pytest
import torch

from advise_tpu_torch.ops import window_probe as wp
from advise_tpu_torch.tools.probe_windows import probe_inputs, probe_offsets, run

H, W = 64, 256


def _numpy_probe(name, o, x):
    if name == "lead_dyn":          # :84-86  DMA x[ds(o, 2)], scratch.sum(axis=0)
        return x[o:o + 2].sum(axis=0)
    if name == "sub_dyn":           # :107-109  DMA x[0, ds(o, 16), :]
        return x[0, o:o + 16, :]
    if name == "sub_aligned":       # :126-131  o8 = multiple_of((o // 8) * 8, 8)
        o8 = (o // 8) * 8
        return x[0, o8:o8 + 16, :]
    if name == "val_dslice":        # :141  lax.dynamic_slice_in_dim(v, o, 16, 0)
        start = min(max(o, 0), H - 16)
        return x[start:start + 16]
    if name == "roll_dyn":          # :156  pltpu.roll(v, -o, 0)[:16, :]
        return np.roll(x, -o, 0)[:16, :]
    if name == "aug_like":          # :184-191  DMA x[0, ds(o, 16), ds(o, 16), :], u8->i32->f32
        return x[0, o:o + 16, o:o + 16, :].astype(np.int32).astype(np.float32)
    if name == "aug_like_aligned":  # :210-218  la = multiple_of((o // 32) * 32, 32)
        la = (o // 32) * 32
        return x[0, o:o + 16, la:la + 64, :].astype(np.int32).astype(np.float32)
    if name == "roll_lane":         # :239  pltpu.roll(v, -o, 1)[:, :128]
        return np.roll(x, -o, 1)[:, :128]
    if name == "flat_u8":           # :266-276  24-row band at ta, residual rolls, [:16, :640]
        ta = (o // 8) * 8
        v = x[0, 2, ta:ta + 24, :].astype(np.int32).astype(np.float32)
        v = np.roll(v, -(o % 8), 0)
        v = np.roll(v, -(3 * o), 1)
        return v[:16, :640]
    raise KeyError(name)


@pytest.fixture(scope="module")
def inputs():
    return probe_inputs("cpu")


# 8 is the script's offset; 13 leaves residuals for the aligned probes; 40
# moves the windows far; 0 the first. P1's leading axis has 8 slices, so
# its two-slice window is in range up to 6
@pytest.mark.parametrize("o", [0, 6, 8, 13, 40])
@pytest.mark.parametrize("name", list(wp.WINDOWS))
def test_probe_plain_matches_its_body(name, o, inputs):
    x = inputs[name]
    if name == "lead_dyn" and o > 6:
        with pytest.raises(IndexError):
            wp.ENTRIES[name](o, x)
        return
    before = wp.ENTRIES[name].launches
    got = wp.ENTRIES[name](o, x)
    want = _numpy_probe(name, o, x.numpy())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert wp.ENTRIES[name].launches == before  # CPU: the plain version, no launch


@pytest.mark.parametrize("name,o", [
    ("lead_dyn", 7), ("sub_dyn", 49), ("aug_like", 241), ("aug_like_aligned", 49),
    ("flat_u8", 48), ("lead_dyn", -1), ("sub_dyn", -3),
])
def test_out_of_range_window_raises(name, o, inputs):
    """A window the TPU kernel's DMA could not read raises, on the CPU as on
    the card, before anything is read."""
    with pytest.raises(IndexError):
        wp.ENTRIES[name](o, inputs[name])


@pytest.mark.parametrize("name,o", [("val_dslice", 60), ("val_dslice", -5),
                                    ("roll_dyn", 200), ("roll_lane", -3)])
def test_clamped_and_rolled_windows_stay_in_range(name, o, inputs):
    """P4 clamps its start and P5/P8 wrap: any offset reads inside the array."""
    got = wp.ENTRIES[name](o, inputs[name])
    np.testing.assert_array_equal(got.numpy(), _numpy_probe(name, o, inputs[name].numpy()))


def test_wrong_input_raises(inputs):
    with pytest.raises(ValueError):
        wp.lead_dyn(8, inputs["lead_dyn"].double())
    with pytest.raises(ValueError):
        wp.flat_u8(8, inputs["aug_like"])


def test_tool_runs_every_probe(inputs):
    """The tool's run() goes through each of the nine entries once, at the
    script's offset 8 but for P1, whose window is in range up to 6."""
    assert probe_offsets() == {name: 6 if name == "lead_dyn" else 8 for name in wp.WINDOWS}
    results = run(inputs)
    assert set(results) == set(wp.ENTRIES)
    for name, (o, got, want) in results.items():
        assert torch.equal(got, want), name
        np.testing.assert_array_equal(got.numpy(), _numpy_probe(name, o, inputs[name].numpy()))
