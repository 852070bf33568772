"""Training: AdamW with f32, bf16 or int8 moments, the step-keyed synthetic
data, atomic checkpoints in the reference's on-disk format, and the
microbatched train step (the port of the reference's ``train/``)."""
