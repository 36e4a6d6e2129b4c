"""Contrastive training: optimizer, train state, metrics, the CLIP trainer."""
