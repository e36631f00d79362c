"""Model zoo of the port (the BERT family for now)."""
