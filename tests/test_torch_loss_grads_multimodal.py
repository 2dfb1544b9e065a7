"""Port parity of ``Model.loss`` and its gradients (the checks of
``test_torch_loss_grads.py``) on the vlm and audio families (the loss
past the patch embeddings; the encoder's memory) and the hybrid family
(through the RG-LRU scan's backward)."""
import pytest

pytest.importorskip("torch")

from test_torch_loss_grads import (check_grads, check_loss,  # noqa: E402
                                   one_torch_thread)

__all__ = ["one_torch_thread"]        # the autouse fixture, used here too

TRAINS = ("internvl2-1b", "seamless-m4t-large-v2", "recurrentgemma-9b")


@pytest.mark.parametrize("arch", TRAINS)
def test_loss_matches_reference(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", TRAINS)
def test_gradients_match_jax_grad(arch):
    check_grads(arch)
