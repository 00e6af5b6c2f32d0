"""Model substrate: the paper's Fig. 6 SNN chip array
(``repro_torch.models.snn``) and the LM stack for the Mamba family
(``layers``, ``mamba``, ``transformer``, ``model``)."""
