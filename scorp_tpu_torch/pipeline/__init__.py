"""SCORP object-refinement stages: mask lifting, view selection, 9-DoF proxy
alignment, and mesh extraction (torch port of `scorp_tpu.pipeline`)."""
