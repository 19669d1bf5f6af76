"""See the package docstring of asr_study_torch."""
