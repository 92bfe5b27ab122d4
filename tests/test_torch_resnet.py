"""The port's SSCD embedder (ResNet-50 -> GeM -> Linear) against the JAX
package's, with weights carried both ways:

- a Flax init -> ``models/export.sscd_from_flax`` -> the port's strict load;
- the torch twin's state dict (``tests/fixtures/torch_backbones.TorchSSCD``,
  the SSCD TorchScript archive's names) -> the port's strict load as it is,
  and -> ``dcr_tpu.models.convert.convert_sscd`` -> the JAX module.

Inputs: 2 images at 64 px from a numpy seed, in the eval transform's
[-1, 1] range. Bound: raw output within 2e-4 * max(1, max|ref|) (f32 on
both sides; a random ResNet-50 grows its activations layer by layer, so the
bound scales with them), L2-normalised embeddings within 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dcr_tpu.models.convert import convert_sscd, torch_state_dict_to_numpy  # noqa: E402
from dcr_tpu.models.resnet import SSCDModel as JaxSSCD  # noqa: E402
from dcr_tpu.models.resnet import gem_pool as jax_gem_pool  # noqa: E402
from dcr_tpu_torch.models import export as EX  # noqa: E402
from dcr_tpu_torch.models.resnet import FrozenBatchNorm, SSCDModel, gem_pool  # noqa: E402
from tests.fixtures.torch_backbones import TorchSSCD  # noqa: E402


def _images(seed=0, n=2, size=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (n, size, size, 3)).astype(np.float32)


def _check(ours: torch.Tensor, ref: np.ndarray) -> None:
    ours = ours.detach().numpy()
    bound = 2e-4 * max(1.0, float(np.abs(ref).max()))
    assert np.abs(ours - ref).max() <= bound, (np.abs(ours - ref).max(), bound)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    assert np.abs(unit(ours) - unit(ref)).max() <= 1e-4


def _port_forward(model: SSCDModel, images: np.ndarray) -> torch.Tensor:
    with torch.inference_mode():
        return model(torch.from_numpy(images).permute(0, 3, 1, 2))


def test_flax_init_carries_into_the_port():
    images = _images(0)
    jmodel = JaxSSCD()
    params = jmodel.init(jax.random.key(3), jnp.zeros((1, 64, 64, 3)))["params"]
    # nonzero running statistics so the batch norms' arithmetic shows
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (np.asarray(x) + rng.uniform(-0.1, 0.1, x.shape).astype(np.float32)
                         if path[-1].key == "mean" else
                         np.asarray(x) * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
                         if path[-1].key in ("var", "scale") else np.asarray(x)), params)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(images)))
    port = SSCDModel().eval()
    missing, unexpected = port.load_state_dict(EX.sscd_from_flax(params), strict=True)
    assert not missing and not unexpected
    _check(_port_forward(port, images), ref)


def test_twin_state_dict_loads_strictly_and_matches_jax():
    images = _images(1)
    torch.manual_seed(0)
    twin = TorchSSCD()
    with torch.no_grad():
        for m in twin.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.1, 0.1)
    twin.eval()
    sd = twin.state_dict()
    assert any(k.endswith("num_batches_tracked") for k in sd)
    port = SSCDModel().eval()
    missing, unexpected = port.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    params = convert_sscd(torch_state_dict_to_numpy(sd))
    ref = np.asarray(JaxSSCD().apply({"params": params}, jnp.asarray(images)))
    ours = _port_forward(port, images)
    _check(ours, ref)
    with torch.no_grad():
        twin_out = twin(torch.from_numpy(images).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.numpy(), twin_out.numpy(), atol=1e-5, rtol=1e-5)


def test_frozen_batchnorm_loads_without_the_batch_counter():
    bn = FrozenBatchNorm(4)
    sd = {"weight": torch.full((4,), 2.0), "bias": torch.ones(4),
          "running_mean": torch.zeros(4), "running_var": torch.ones(4)}
    bn.load_state_dict(sd, strict=True)
    x = torch.ones(1, 4, 2, 2)
    expected = 2.0 / np.sqrt(1.0 + 1e-5) + 1.0
    np.testing.assert_allclose(bn(x).numpy(), np.full((1, 4, 2, 2), expected), rtol=1e-6)


def test_gem_pool_matches_jax():
    x = np.random.default_rng(2).uniform(-1, 2, (2, 3, 5, 5)).astype(np.float32)
    ref = np.asarray(jax_gem_pool(jnp.asarray(x.transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(gem_pool(torch.from_numpy(x)).numpy(), ref, rtol=1e-6,
                               atol=1e-6)


def test_backbone_files_load_strictly_and_mismatches_are_named(tmp_path):
    """``load_backbone_params`` reads a plain state dict and a TorchScript
    archive (the SSCD distribution format); ``build_backbone`` loads either
    strictly, and names the keys of weights that do not fit."""
    from dcr_tpu_torch.eval.runner import build_backbone, load_backbone_params

    torch.manual_seed(1)
    twin = TorchSSCD().eval()
    x = torch.from_numpy(_images(3)).permute(0, 3, 1, 2)
    torch.save(twin.state_dict(), tmp_path / "sscd.pt")
    with torch.no_grad():
        torch.jit.trace(twin, x).save(str(tmp_path / "sscd.torchscript.pt"))
        want = twin(x)
    for name in ("sscd.pt", "sscd.torchscript.pt"):
        sd = load_backbone_params("sscd", "resnet50_disc", str(tmp_path / name))
        model = build_backbone("sscd", "resnet50_disc", "cpu", state_dict=sd)
        with torch.inference_mode():
            np.testing.assert_allclose(model(x).numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    bad = dict(twin.state_dict())
    bad["embeddings.kernel"] = bad.pop("embeddings.weight")
    with pytest.raises(ValueError, match="missing embeddings.weight.*unexpected embeddings.kernel"):
        build_backbone("sscd", "resnet50_disc", "cpu", state_dict=bad)
    with pytest.raises(ValueError, match="only the sscd backbone"):
        load_backbone_params("dino", "dino_vits16", str(tmp_path / "sscd.pt"))
