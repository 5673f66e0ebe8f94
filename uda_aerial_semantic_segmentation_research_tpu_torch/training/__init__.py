"""Training: states, step factories, the three phases' trainers, the phase
lifecycle and the three-phase pipeline."""
