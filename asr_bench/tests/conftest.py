"""The card fixture: tests marked requires_cuda decide here, when they run,
whether there is a card."""

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
