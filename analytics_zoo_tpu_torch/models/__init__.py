"""Model zoo of the port: the BERT family, the recommendation family,
the image models (`image/`), the text classifier, the anomaly detector,
Seq2Seq, KNRM and the VAE."""

from analytics_zoo_tpu_torch.models.vae import VAE  # noqa: F401
