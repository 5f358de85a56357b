"""An MoE model trained under ``sharding.use_rules`` with per-layer remat.

``use_rules`` is thread-local.  Each layer runs under the non-reentrant
checkpoint, whose recompute in backward runs on the thread that runs
the backward: on a card, autograd's device thread, which does not see
the caller's rules.  ``transformer.backbone`` therefore reads the
dispatch shards once, outside the checkpoint, and passes them to
``moe.apply_moe``.  The CPU test runs the backward in another thread,
as the card does; the card test runs it there.  No JAX here, so the
card test runs on a machine without it::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \\
        tests/test_torch_moe_remat.py
"""

import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_reduce  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import device_batch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import use_rules  # noqa: E402
from repro_torch.utils.tree import flatten_with_names, map_with_names  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Two intra-op threads: the tier-1 run uses six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _case(device, **over):
    cfg = smoke_reduce(get_config(ARCH)).with_overrides(
        n_layers=2, dtype="float32", **over)
    shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    params = map_with_names(lambda _, t: t.to(device), build_model(
        cfg, device="cpu").init_params(0))
    return cfg, params, device_batch(cfg, shape, 0, device)


def _grads(cfg, params, batch, n, thread=False):
    """(loss, aux, gradients) under ``dp_shards`` n; with ``thread`` the
    backward runs in another thread, outside the rules."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten_with_names(params)}
    api = build_model(cfg, device=batch["tokens"].device)
    tree = map_with_names(lambda k, _: leaves[k], params)
    with use_rules(None, {"dp_shards": n}):
        loss, m = api.train_loss(tree, batch)
        if not thread:
            grads = torch.autograd.grad(loss, list(leaves.values()))
    if thread:
        out = {}

        def backward():
            try:
                out["g"] = torch.autograd.grad(loss, list(leaves.values()))
            except Exception as e:      # raised again in this thread
                out["e"] = e
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join()
        if "e" in out:
            raise out["e"]
        grads = out["g"]
    return loss.detach(), m["aux"].detach(), grads


def test_remat_recompute_keeps_the_rules_shard_count():
    """The recompute sees the dispatch shards the forward read, also from
    a thread without the rules: the same loss and gradients, bit for
    bit, as a backward in the rules' thread, and not the one-shard
    run's."""
    cfg, params, batch = _case("cpu", remat_policy="nothing_saveable")
    loss, aux, grads = _grads(cfg, params, batch, 2)
    t_loss, t_aux, t_grads = _grads(cfg, params, batch, 2, thread=True)
    _, one_aux, _ = _grads(cfg, params, batch, 1)
    assert torch.equal(loss, t_loss) and torch.equal(aux, t_aux)
    assert all(torch.equal(a, b) for a, b in zip(grads, t_grads))
    assert float(aux) != float(one_aux)


@pytest.mark.gpu
def test_remat_under_rules_trains_on_card():
    """On the card the recompute runs on autograd's device thread: value
    and gradient under ``use_rules`` with remat equal the run without
    remat (rtol 1e-5), with two dispatch shards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the recompute thread is the card's")
    cfg, params, batch = _case("cuda", remat_policy="nothing_saveable")
    loss, aux, grads = _grads(cfg, params, batch, 2)
    plain = cfg.with_overrides(remat_policy="none")
    p_loss, p_aux, p_grads = _grads(plain, params, batch, 2)
    _, one_aux, _ = _grads(cfg, params, batch, 1)
    torch.testing.assert_close(loss, p_loss, rtol=1e-5, atol=0)
    torch.testing.assert_close(aux, p_aux, rtol=1e-5, atol=0)
    for a, b in zip(grads, p_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert float(aux) != float(one_aux)
