"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

TF32_FLOPS = 495e12   # tensor cores, TF32 (3xTF32 emulated float32 runs there)
F32_FLOPS = 67e12     # float32 outside the tensor cores
HBM_BYTES = 3.35e12   # HBM3 bytes a second


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or what
    kept it from reading them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
