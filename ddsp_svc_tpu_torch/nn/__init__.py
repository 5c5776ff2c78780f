"""Network modules: layers, PCmer, Unit2Control, NSF-HiFiGAN, HuBERT,
CREPE."""
