from tpukern_torch.harness.bench import run_benchmark

__all__ = ["run_benchmark"]
