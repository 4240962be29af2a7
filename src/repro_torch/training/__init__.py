"""The training substrate of the port (PyTorch counterpart of
``repro.training``): the deterministic data pipeline (``data``), AdamW
with fp32 master weights (``optimizer``), int8 error-feedback gradient
compression (``compression``), the training step (``train_step``) and
atomic checkpoints in the reference's layout (``checkpoint``) and the
elastic meshes a restart restores onto (``elastic``)."""
