"""Rigid-body ops on torch tensors and the component-dynamics core (`cdyn`)."""
