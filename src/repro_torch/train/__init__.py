"""Loss and train-step factory."""
