"""Serving layer of the port: the generation engine and
`InferenceModel`."""
