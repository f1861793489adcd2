from .evaluation import evaluate_gen, generate_samples
