"""Finetune the diffusion stack (PyTorch port of ``dcr-train``).

    python -m dcr_tpu_torch.cli.train --output_dir=runs/x \\
        --data.train_data_dir=<class-folder of PNGs> --max_train_steps=100

Same flags and ``--config=<config.json>`` as the JAX package's ``dcr-train``.
It trains on one CUDA device (``DCR_TPU_PLATFORM=cpu`` selects the CPU), from
seeded random weights, or as N processes, one device each, under torchrun
or the JAX package's variables:

    torchrun --nproc_per_node=N -m dcr_tpu_torch.cli.train --mesh.data=N ...
    COORDINATOR_ADDRESS=host:port NUM_PROCESSES=N PROCESS_ID=<r> \
        python -m dcr_tpu_torch.cli.train --mesh.data=N ...

``--mesh.data`` x ``--mesh.seq`` must equal N (``--mesh.data=-1`` takes
what ``--mesh.seq`` leaves); ``train_batch_size`` is per data rank. The
backend is NCCL on the card and gloo on the CPU. It writes a sample grid every ``save_steps``
(``<output_dir>/generations/step_<n>.png``), resumes from
``<output_dir>/checkpoints`` (the newest valid step) and exports
``<output_dir>/checkpoint`` at the end. A setting the port does not run yet
is refused with ``NotPortedError``.

``--optim.use_8bit_adam=true`` keeps Adam's moments as 8-bit codes
(``core/adam8bit.py``). The run writes ``<output_dir>/trace.jsonl`` (read it
with ``python -m tools.trace_report <output_dir>``); ``DCR_PROFILE_AT_STEP=K``
captures ``DCR_PROFILE_STEPS`` steps from micro-step K with ``torch.profiler``
into ``<output_dir>/profile``.

Exit codes: 0 when training ends; 83 (``EXIT_PREEMPTED``) after a SIGTERM
or SIGINT, once the final checkpoint is written (a second signal ends the
process at once); 85 (``EXIT_OOM``) when the device runs out of memory;
89 (``EXIT_HANG``) when ``--fault.hang_timeout_s`` (or
``DCR_HANG_TIMEOUT_S``) passes without a finished step, with every thread's
stack on stderr. The NaN abort and exits 83, 85 and 89 write
``<output_dir>/flightrec_<rank>.json`` first. On several processes every
rank ends with the same code. ``DCR_FAULTS`` injects faults
(``utils/faults.py``), e.g. ``DCR_FAULTS=sigterm@step=2`` or ``oom@step=2``.
"""

from __future__ import annotations

import logging

from dcr_tpu_torch.cli import device_from_env
from dcr_tpu_torch.core import dist
from dcr_tpu_torch.core.config import TrainConfig, parse_cli
from dcr_tpu_torch.core.coordination import EXIT_PREEMPTED
from dcr_tpu_torch.diffusion.sample_hook import make_sample_hook
from dcr_tpu_torch.diffusion.trainer import Trainer
from dcr_tpu_torch.utils import faults

log = logging.getLogger("dcr_tpu_torch")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s",
                        force=True)
    cfg = parse_cli(TrainConfig, argv)
    reg = faults.registry()
    if reg:
        log.warning("fault injection ACTIVE (DCR_FAULTS): %s", reg.pending())
    if cfg.warm.dir:
        log.info("warm cache enabled: %s (the step's kernel libraries resolved after "
                 "restore)", cfg.warm.dir)
    trainer = Trainer(cfg, sample_hook=make_sample_hook(), device=device_from_env())
    trainer.install_preemption_handler()
    metrics = trainer.train()
    if reg and reg.pending():
        log.warning("fault entries never fired (check coordinates): %s", reg.pending())
    dist.shutdown()
    if trainer.preempted_exit:
        log.warning("preempted: final checkpoint written; exiting with code %d for the "
                    "restart wrapper", EXIT_PREEMPTED)
        raise SystemExit(EXIT_PREEMPTED)
    log.info("training done: %s", metrics)


if __name__ == "__main__":
    main()
