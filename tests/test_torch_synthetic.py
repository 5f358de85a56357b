"""Port parity: the synthetic token pipeline (``repro_torch.data.synthetic``)
against the reference's (``repro.data.synthetic``) on the CPU.

Band: exact.  ``host_batch`` is numpy on both sides and draws the same
values in the same order, so every array (and its dtype) is equal, for a
dense, the VLM and the encoder-decoder config; a stream restarted at a
step gives the batches of the uninterrupted stream.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

SHAPE = ShapeConfig("t", seq_len=96, global_batch=3, kind="train")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi-3-vision-4.2b",
                                  "whisper-medium"])
def test_host_batch_equals_reference(arch):
    jcfg = jconfigs.smoke_reduce(jconfigs.get_config(arch))
    cfg = configs.smoke_reduce(configs.get_config(arch))
    dcfg = syn.DataConfig(seed=7, mean_doc_len=24)
    jdcfg = jsyn.DataConfig(seed=7, mean_doc_len=24)
    for step in range(3):
        mine = syn.host_batch(cfg, SHAPE, step, dcfg)
        ref = jsyn.host_batch(jcfg, SHAPE, step, jdcfg)
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert mine[k].dtype == ref[k].dtype, k
            assert np.array_equal(mine[k], ref[k]), (arch, step, k)
    assert (syn.EOS, syn.PAD) == (jsyn.EOS, jsyn.PAD)


def test_stream_resume_and_device_batch():
    cfg = configs.smoke_reduce(configs.get_config("phi-3-vision-4.2b"))
    full = syn.SyntheticStream(cfg, SHAPE, device="cpu")
    batches = [next(full) for _ in range(4)]
    resumed = syn.SyntheticStream(cfg, SHAPE, start_step=2, device="cpu")
    for want in batches[2:]:
        got = next(resumed)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    b = syn.device_batch(cfg, SHAPE, 0, device="cpu")
    host = syn.host_batch(cfg, SHAPE, 0)
    assert {k: v.dtype for k, v in b.items()} == {
        "tokens": torch.int32, "labels": torch.int32, "mask": torch.int32,
        "patch_embeds": torch.float32}
    for k, v in host.items():
        assert np.array_equal(b[k].numpy(), v), k
