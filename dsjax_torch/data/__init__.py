"""Training data: manifests, batch samplers, the host-feature dataset and the loader."""
