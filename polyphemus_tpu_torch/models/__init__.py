from .vae import VAE, Decoder  # noqa: F401
