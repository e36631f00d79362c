"""Model zoo of the port: the BERT family, the recommendation family
and the image models (`image/`)."""
