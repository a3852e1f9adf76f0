"""The plain reference: the models, the VAE and DDIM in float32 PyTorch,
written from the published architectures and read by diffusers key names.
It imports nothing of the program under test and nothing of JAX."""
