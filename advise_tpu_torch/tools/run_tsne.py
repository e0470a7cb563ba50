"""t-SNE of dumped features (counterpart of ``advise_tpu/tools/run_tsne.py``;
reference ``utils/run_tsne.py``): sklearn's TSNE over the ``.npz`` that
``utils/visualization.py get_features`` writes, drawn by matplotlib.

    python -m advise_tpu_torch.tools.run_tsne --features feats.npz --output tsne.png \\
        [--perplexity 30] [--max-points 5000]

Where sklearn or matplotlib does not import, it raises and names it.
"""

from __future__ import annotations

import argparse
import importlib
import logging

import numpy as np

logger = logging.getLogger(__name__)


def _need(module: str, package: str):
    try:
        return importlib.import_module(module)
    except ImportError as err:
        raise ImportError(f"run_tsne needs {package}, which does not import here") from err


def run_tsne(features: np.ndarray, labels: np.ndarray, perplexity: float = 30.0, seed: int = 0) -> np.ndarray:
    """The [N, 2] embedding of ``features`` [N, D]: 2-D TSNE with PCA init,
    ``random_state`` ``seed`` and the perplexity cut to at most (N - 1) / 3
    (at least 2). ``labels`` are not read (the plot colours by them)."""
    manifold = _need("sklearn.manifold", "scikit-learn")
    perplexity = min(perplexity, max((len(features) - 1) / 3.0, 2.0))
    return manifold.TSNE(n_components=2, perplexity=perplexity, init="pca",
                         random_state=seed).fit_transform(features)


def main(argv=None) -> str:
    """Reads ``--features``, keeps at most ``--max-points`` rows (a seeded
    choice), embeds them and writes the scatter, coloured by label, to
    ``--output``; returns that path."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", required=True)
    parser.add_argument("--output", default="tsne.png")
    parser.add_argument("--perplexity", type=float, default=30.0)
    parser.add_argument("--max-points", type=int, default=5000)
    args = parser.parse_args(argv)

    data = np.load(args.features)
    feats, labels = data["features"], data["labels"]
    if len(feats) > args.max_points:
        idx = np.random.default_rng(0).choice(len(feats), args.max_points, replace=False)
        feats, labels = feats[idx], labels[idx]
    emb = run_tsne(feats, labels, args.perplexity)

    matplotlib = _need("matplotlib", "matplotlib")
    matplotlib.use("Agg")
    plt = _need("matplotlib.pyplot", "matplotlib")
    plt.figure(figsize=(8, 8))
    plt.scatter(emb[:, 0], emb[:, 1], c=labels, cmap="tab20", s=4, alpha=0.7)
    plt.axis("off")
    plt.tight_layout()
    plt.savefig(args.output, dpi=150)
    plt.close()
    print(f"t-SNE written to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
