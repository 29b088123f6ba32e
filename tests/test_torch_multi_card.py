"""The kernels and the device helpers on more than one card.

* ``resolve_device("cuda")`` comes back with the current card's index (a
  mesh shard never follows whichever card is current later);
* each kernel's ``LaunchCounter`` counts launches per card beside its
  total;
* on a host with two or more cards (``cuda`` marker): K1 and K2 launched on
  tensors of ``cuda:1`` while ``cuda:0`` is current match their plain
  versions.  The kernels set their shared-memory limit per device and launch
  in their tensors' device context.

This file imports nothing of JAX, so the card's machine runs it as is:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_multi_card.py``.
"""

import pytest
import torch

from consensus_tpu_torch.ops import decode_attention as da
from consensus_tpu_torch.ops import flash_attention as fa
from consensus_tpu_torch.utils.device import resolve_device


def test_resolve_device_returns_an_indexed_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


@pytest.mark.parametrize("counter", [fa.LaunchCounter("k1"), da.LaunchCounter("k2")],
                         ids=["flash_attention", "decode_attention"])
def test_launch_counter_counts_per_card(counter):
    for device in ("cuda:0", "cuda:1", "cuda:1"):
        counter.add((), (), torch.device(device))
    assert counter.count == 3
    assert counter.by_device == {"cuda:0": 1, "cuda:1": 2}
    counter.reset()
    assert counter.count == 0 and counter.by_device == {}


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


@pytest.mark.cuda
def test_kernels_on_a_second_card_while_the_first_is_current(second_card):
    device = second_card
    g = torch.Generator(device=device).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    q, k, v = randn(2, 320, 32, 128), randn(2, 320, 8, 128), randn(2, 320, 8, 128)
    lengths = torch.tensor([320, 150], dtype=torch.int32, device=device)
    starts = torch.tensor([0, 170], dtype=torch.int32, device=device)
    before = fa.launches.by_device.get(str(device), 0)
    out = fa.flash_attention(q, k, v, lengths, starts)
    assert torch.cuda.current_device() == 0
    assert fa.launches.by_device.get(str(device), 0) == before + 1
    plain = fa.flash_attention_reference(q, k, v, lengths, starts)
    torch.testing.assert_close(out.float(), plain.float(), atol=5e-3, rtol=1e-2)

    args = (randn(8, 32, 128), randn(4, 300, 8, 128), randn(4, 300, 8, 128),
            randn(8, 64, 8, 128), randn(8, 64, 8, 128),
            torch.tensor([0, 50, 100, 299], dtype=torch.int32, device=device),
            torch.tensor([310, 260, 210, 11], dtype=torch.int32, device=device), 10, 2, 4)
    before = da.launches.by_device.get(str(device), 0)
    out = da.decode_attention(*args, scale=128 ** -0.5)
    assert da.launches.by_device.get(str(device), 0) == before + 1
    plain = da.decode_attention_reference(*args, scale=128 ** -0.5)
    torch.testing.assert_close(out.float(), plain.float(), atol=5e-3, rtol=1e-2)
    torch.cuda.synchronize(device)
