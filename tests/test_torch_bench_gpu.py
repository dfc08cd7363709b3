"""The port's bench probes on the card.

rate_probe and measure_python_ceiling stand for the original's
jax.device_put loops: pageable host -> device copies onto the port's
resolved device. Without a CUDA device these tests skip. They import
neither jax nor the original package, so they also run on a machine with
only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_bench_gpu.py
"""

import pytest
import torch

import elbencho_tpu_torch.bench as bench


@pytest.fixture()
def card(monkeypatch):
    """cuda:0, resolved by the bench's own device resolution, with every
    buffer the probes copy into recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probes measure the card")
    monkeypatch.delenv("EBT_TORCH_DEVICE", raising=False)
    device = bench.bench_device()
    assert device == torch.device("cuda", 0)
    bufs = []
    real_put = bench._put

    def put(src, dev, sync=True):
        dst = real_put(src, dev, sync)
        bufs.append(dst)
        return dst

    monkeypatch.setattr(bench, "_put", put)
    return device, bufs


@pytest.mark.gpu
def test_rate_probe_copies_onto_the_card(card):
    device, bufs = card
    rate = bench.rate_probe(device, budget_s=0.5)
    assert rate > 0
    assert bufs and all(b.device == device for b in bufs)
    assert all(b.numel() == bench.CHUNK for b in bufs)


@pytest.mark.gpu
@pytest.mark.parametrize("total", [bench.CHUNK, 64 << 20])
def test_python_ceiling_copies_onto_the_card(card, total):
    device, bufs = card
    rate = bench.measure_python_ceiling(device, total)
    assert rate > 0
    # the warm copy, then one per CHUNK of the window
    assert len(bufs) == 1 + total // bench.CHUNK
    assert all(b.device == device for b in bufs)
    # a confirmed copy holds the source's bytes
    src = bench._probe_source()
    assert torch.equal(bench._put(src, device).cpu(), src)
