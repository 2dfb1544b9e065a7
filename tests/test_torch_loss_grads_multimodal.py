"""Port parity of ``Model.loss`` and its gradients (the checks of
``test_torch_loss_grads.py``) on the vlm and audio families, which train
(the loss past the patch embeddings; the encoder's memory), and the
hybrid family, whose RG-LRU scan refuses autograd: its loss under
``torch.no_grad()`` only."""
import pytest

pytest.importorskip("torch")

from test_torch_loss_grads import (check_grads, check_loss,  # noqa: E402
                                   check_scan_refuses, one_torch_thread)

__all__ = ["one_torch_thread"]        # the autouse fixture, used here too

TRAINS = ("internvl2-1b", "seamless-m4t-large-v2")
RECURRENT = ("recurrentgemma-9b",)


@pytest.mark.parametrize("arch", TRAINS + RECURRENT)
def test_loss_matches_reference(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", TRAINS)
def test_gradients_match_jax_grad(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_scan_refuses_grad(arch):
    check_scan_refuses(arch)
