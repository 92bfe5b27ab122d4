"""Observability of the port: live copy-risk scoring (:mod:`dcr_tpu_torch.obs.copyrisk`)."""
