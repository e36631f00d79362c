"""Model zoo of the port: the BERT family and the recommendation
family."""
