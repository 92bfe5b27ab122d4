"""Command-line entry points of the PyTorch port.

    python -m dcr_tpu_torch.cli.sample --model_path=... --num_batches=...
    python -m dcr_tpu_torch.cli.train --output_dir=... --data.train_data_dir=...
    python -m dcr_tpu_torch.cli.precompute --pipe.latent_cache=... --data.train_data_dir=...
    python -m dcr_tpu_torch.cli.evaluate --query_dir=... --values_dir=...
    python -m dcr_tpu_torch.cli.search {download|embed|search|build|append|verify|query|
                                         train-ivf|stats} ...
    python -m dcr_tpu_torch.cli.mitigate --model_path=... [--rand_augs=...] [--rand_noise_lam=...]
    python -m dcr_tpu_torch.cli.serve --model_path=... [--port=...] [--risk.index_path=...]

Installed, they are ``dcr-sample-torch``, ``dcr-train-torch``,
``dcr-precompute-latents-torch``, ``dcr-eval-torch``, ``dcr-search-torch``,
``dcr-mitigate-torch`` and ``dcr-serve-torch``. They
run on CUDA. ``DCR_TPU_PLATFORM=cpu`` (the JAX CLIs' own switch) selects
the CPU; nothing else does, and without a GPU the commands fail.
"""

import os


def device_from_env() -> str:
    return "cpu" if os.environ.get("DCR_TPU_PLATFORM", "").lower() == "cpu" else "cuda"
