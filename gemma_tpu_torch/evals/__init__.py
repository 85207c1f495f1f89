"""Eval and benchmark helpers (counterpart of gemma_tpu/evals/)."""
