"""Command-line probes of the card's rates (ports of the repository's
``tools/{vpu,exp,scan}_probe.py``); run each as
``python -m triangle_splatting_tpu_torch.tools.<name>``."""
