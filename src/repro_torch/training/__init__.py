"""Video-model training, port of ``repro.training``: optimizers and
schedules, data pipelines, checkpoints and the detector / classifier
training loops.  LLM training (``make_train_step``, ``train_llm``) is not
ported yet."""
from repro_torch.training import checkpoint, data, optimizer, train_loop  # noqa: F401
