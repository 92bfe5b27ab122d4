"""dcr-serve on one device or a fleet: the online generation service of the port.

Layer map (``dcr_tpu/serve/``):

- :mod:`dcr_tpu_torch.serve.queue`: bounded admission queue, typed
  overload/drain rejections, bucket-tagged requests;
- :mod:`dcr_tpu_torch.serve.batcher`: deadline-aware dynamic batching;
- :mod:`dcr_tpu_torch.serve.cache`: LRU prompt-embedding cache keyed on
  (tokenizer fingerprint, prompt, mitigation parameters);
- :mod:`dcr_tpu_torch.serve.worker`: the resident core (per-bucket batch
  samplers at a fixed padded shape, per-request draws, copy-risk scoring,
  the batch watchdog);
- :mod:`dcr_tpu_torch.serve.ingest`: live provenance, each scored
  generation's SSCD row streamed into the store's WAL;
- :mod:`dcr_tpu_torch.serve.server`: stdlib HTTP front end;
- :mod:`dcr_tpu_torch.serve.fleet`: worker leases and the request journal;
- :mod:`dcr_tpu_torch.serve.scrape`: the workers' Prometheus text, scraped
  and merged under ``worker`` labels;
- :mod:`dcr_tpu_torch.serve.supervisor`: N worker processes behind one
  front end, requeue and respawn around their deaths.

Entry points: ``dcr-serve-torch`` (:mod:`dcr_tpu_torch.cli.serve`) and
``dcr-status-torch`` (:mod:`dcr_tpu_torch.cli.status`). SIGTERM stops
admission, finishes the backlog and exits with
:data:`dcr_tpu_torch.core.resilience.EXIT_PREEMPTED` (83).
"""
