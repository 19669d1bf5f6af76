"""Data and tensor parallelism over ``torch.distributed`` (the mesh
plumbing of ``asr_study_tpu/train/trainer.py`` and
``asr_study_tpu/parallel/tp.py``)."""
