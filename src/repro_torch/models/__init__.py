"""Model substrate: so far the paper's Fig. 6 SNN chip array
(``repro_torch.models.snn``)."""
