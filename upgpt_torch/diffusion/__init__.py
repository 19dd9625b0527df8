"""Diffusion schedules, the latent-diffusion model and samplers."""
