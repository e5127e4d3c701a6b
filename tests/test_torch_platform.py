"""The port's platform micro-API: the torch backend against the numpy
backend, op by op, on the same seeded inputs.

`chip_smoke.BACKEND_CASES` covers the 17 ops of
`easydist_tpu_torch.platform._API`; each case takes a device and raises on
a mismatch.  The tests run them on the CPU; `chip_smoke.py` runs the same
cases on CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import BACKEND_CASES, aten
from easydist_tpu_torch import platform
from easydist_tpu_torch.platform import numpy_backend as nb


def test_cases_cover_the_api():
    assert sorted(BACKEND_CASES) == sorted(platform._API)


@pytest.mark.parametrize("name", sorted(BACKEND_CASES))
def test_torch_backend_matches_numpy(name):
    BACKEND_CASES[name]("cpu")


def test_registry_default_is_torch_and_switches():
    try:
        platform.init_backend()
        assert platform.get_backend() == "torch"
        assert platform.Tensor is torch.Tensor
        platform.init_backend("numpy")
        assert platform.Tensor is np.ndarray
        assert platform.batched_call is nb.batched_call
    finally:
        platform.init_backend("torch")


def test_writes_input_reads_the_schema():
    assert platform.writes_input(aten.add_.Tensor)
    assert platform.writes_input(aten.copy_.default)
    assert platform.writes_input(aten.add.out)
    assert not platform.writes_input(aten.add.Tensor)
    assert not platform.writes_input(np.add)
