"""Training on the port: FLUX LoRA fine-tuning (training/lora.py)."""
