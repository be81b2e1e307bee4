"""Mixture-of-experts motion VAE: its option registry and the network."""
