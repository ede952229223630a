"""The AKI model: configs, SigLIP, Perceiver, splice, Phi-3, decoupled vocab."""
