"""``python -m tf_1d_2d_segmentation_end2endpipelines_torch
train|test|serve|predict|train1d|test1d|predict1d ...``: the port's
command line (JAX: drivers.py:895-933, :936-946, :956-968, :1046-1078)."""
from __future__ import annotations

import argparse
import typing as tp


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m tf_1d_2d_segmentation_end2endpipelines_torch",
        description="tpuseg on PyTorch/CUDA (the ported verbs)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_tr = sub.add_parser(
        "train", help="fold-loop training from a Train_Configs.ini; writes "
        "<save_dir>/Fold_<fold>/best.pt")
    p_tr.add_argument("config", nargs="?", default="Train_Configs.ini")
    p_tr.add_argument("--device", default="cuda",
                      help="torch device to train on (default: cuda)")
    p_tr.add_argument("--seed", type=int, default=None,
                      help="replaces the INI seed (weights, shuffle, split)")
    p_te = sub.add_parser(
        "test", help="fold-loop evaluation from a Test_Configs.ini: masks, "
        "metrics and reports under <save_dir>/test_results/fold_<fold>")
    p_te.add_argument("config", nargs="?", default="Test_Configs.ini")
    p_te.add_argument("--device", default="cuda",
                      help="torch device to evaluate on (default: cuda)")
    p_srv = sub.add_parser(
        "serve", help="HTTP serving of a trained fold (POST an image, get "
        "a PNG mask); weights from <save_dir>/Fold_<fold>/best.pt")
    p_srv.add_argument("config", nargs="?", default="Train_Configs.ini")
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8000)
    p_srv.add_argument("--fold", type=int, default=1)
    p_srv.add_argument("--max-batch", type=int, default=1)
    p_srv.add_argument("--threshold", type=float, default=0.5)
    p_srv.add_argument("--device", default="cuda",
                       help="torch device to serve on (default: cuda)")
    p_srv.add_argument("--seed", type=int, default=None,
                       help="seed of the weights served when best.pt is "
                       "absent (default: the INI seed)")
    p_srv.add_argument("--int8", action="store_true",
                       help="int8 serving (not ported yet: raises)")
    p_prd = sub.add_parser(
        "predict", help="segment unlabeled images (a file or a folder) with "
        "a trained fold's <save_dir>/Fold_<fold>/best.pt; writes PNG masks")
    p_prd.add_argument("config", nargs="?", default="Train_Configs.ini")
    p_prd.add_argument("--input", required=True)
    p_prd.add_argument("--out", default="predicted_masks")
    p_prd.add_argument("--fold", type=int, default=1)
    p_prd.add_argument("--threshold", type=float, default=0.5)
    p_prd.add_argument("--batch", type=int, default=8)
    p_prd.add_argument("--tta", default="",
                       help="test-time augmentation: comma list of "
                       "invertible views to average (hflip,vflip,hvflip"
                       "[,rot90,rot180,rot270 if square]; 'all'); every "
                       "view of a batch runs in one forward")
    p_prd.add_argument("--device", default="cuda",
                       help="torch device to predict on (default: cuda)")
    p_prd.add_argument("--seed", type=int, default=None,
                       help="seed of the weights used when best.pt is "
                       "absent (default: the INI seed)")
    for verb, what in (("train1d", "train on a .pt signal set; writes "
                        "<save_dir>/best.pt"),
                       ("test1d", "NILM evaluation of a trained 1D model "
                        "on the config's test_set"),
                       ("predict1d", "inference on unlabeled .pt signals; "
                        "writes an .npz of predictions")):
        p = sub.add_parser(verb, help=what)
        p.add_argument("config", nargs="?", default="Signal_Configs.ini")
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default: cuda)")
        p.add_argument("--seed", type=int, default=None,
                       help="replaces the INI seed (weights, shuffle)")
        if verb == "predict1d":
            p.add_argument("--input", default=None,
                           help="input .pt (defaults to the config test_set)")
            p.add_argument("--out", default="predictions_1d.npz")
    args = parser.parse_args(argv)
    if args.cmd == "train":
        from .drivers import train
        train(args.config, device=args.device, seed=args.seed)
    elif args.cmd == "test":
        from .drivers import test
        test(args.config, device=args.device)
    elif args.cmd == "serve":
        from .serve import serve
        serve(args.config, host=args.host, port=args.port, fold=args.fold,
              max_batch=args.max_batch, threshold=args.threshold,
              int8=args.int8, device=args.device, seed=args.seed)
    elif args.cmd == "train1d":
        from .drivers_1d import train_1d
        train_1d(args.config, device=args.device, seed=args.seed)
    elif args.cmd == "test1d":
        from .drivers_1d import test_1d
        test_1d(args.config, device=args.device, seed=args.seed)
    elif args.cmd == "predict1d":
        from .drivers_1d import predict_1d
        predict_1d(args.config, input_path=args.input, out_path=args.out,
                   device=args.device, seed=args.seed)
    elif args.cmd == "predict":
        from .drivers import predict
        predict(args.config, input_path=args.input, out_dir=args.out,
                fold=args.fold, threshold=args.threshold, batch=args.batch,
                tta=args.tta, device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
