"""dcr-serve on one device: the online generation service of the port.

Layer map (``dcr_tpu/serve/``):

- :mod:`dcr_tpu_torch.serve.queue`: bounded admission queue, typed
  overload/drain rejections, bucket-tagged requests;
- :mod:`dcr_tpu_torch.serve.batcher`: deadline-aware dynamic batching;
- :mod:`dcr_tpu_torch.serve.cache`: LRU prompt-embedding cache keyed on
  (tokenizer fingerprint, prompt, mitigation parameters);
- :mod:`dcr_tpu_torch.serve.worker`: the resident core (per-bucket batch
  samplers at a fixed padded shape, per-request draws, copy-risk scoring);
- :mod:`dcr_tpu_torch.serve.ingest`: live provenance, each scored
  generation's SSCD row streamed into the store's WAL;
- :mod:`dcr_tpu_torch.serve.server`: stdlib HTTP front end.

Entry point: ``dcr-serve-torch`` (:mod:`dcr_tpu_torch.cli.serve`). SIGTERM
stops admission, finishes the backlog and exits with
:data:`dcr_tpu_torch.core.resilience.EXIT_PREEMPTED` (83). The fleet
(supervisor, leases, journal) is not ported.
"""
