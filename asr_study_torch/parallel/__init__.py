"""Data parallelism over ``torch.distributed`` (the mesh plumbing of
``asr_study_tpu/train/trainer.py``)."""
