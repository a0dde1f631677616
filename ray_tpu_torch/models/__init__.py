"""Models of the port (PyTorch): the Llama serving and training forwards."""
