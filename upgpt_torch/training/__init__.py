"""Training: AdamW + EMA train state and the learning-rate schedules."""
