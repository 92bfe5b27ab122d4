"""LAION-scale embedding search: embed, the sharded embedding store, its
top-k engine and the brute force (counterpart of ``dcr_tpu/search``)."""
