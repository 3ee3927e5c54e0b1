"""Parallelism (counterpart of `deeplearning4j_tpu/parallel/`). Only the
single-device attention entry is ported (`sequence.attention`); ring and
Ulysses sequence parallelism, meshes and the trainers need several cards
(ROADMAP A.13)."""
