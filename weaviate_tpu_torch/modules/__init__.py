"""Module tier of the port: the device rerank modules (``device/``) and
the ``Module`` base they register under. The host module registry and its
providers (vectorizers, host rerankers, generative) are not ported yet
(ROADMAP queue A, slice 9)."""
