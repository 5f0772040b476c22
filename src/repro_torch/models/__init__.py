"""Dense rope decoder (the llama family) in plain PyTorch."""
