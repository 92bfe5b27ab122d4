"""Observability of the port: live copy-risk scoring (:mod:`dcr_tpu_torch.obs.copyrisk`),
device memory (:mod:`~dcr_tpu_torch.obs.memwatch`), the online recall probe
(:mod:`~dcr_tpu_torch.obs.recall_probe`) and the fleet's SLO engine
(:mod:`~dcr_tpu_torch.obs.slo`)."""
