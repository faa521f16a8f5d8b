"""The plain reference: each model family's forward (``<family>.py``), the
grouping, the layers and a fine-tuning step, in f32 plain PyTorch with TF32
off. It imports nothing of the program, of JAX or of the JAX package."""
