"""Runtime steps of the LM: training, LM-scale distillation, serving."""
from repro_torch.runtime.steps import make_decode_step, make_distill_step_lm, make_prefill_step, make_train_step

__all__ = ["make_decode_step", "make_distill_step_lm", "make_prefill_step", "make_train_step"]
