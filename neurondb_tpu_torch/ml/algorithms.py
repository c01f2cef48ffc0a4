"""Algorithm dispatch table — registers the ported trainers with the API.

Counterpart of ``neurondb_tpu/ml/algorithms.py``: every family it
registers (k-means and mini-batch k-means, the linear family, GMM, PCA,
DBSCAN, agglomerative clustering, kNN, naive Bayes, SVM (primal, dual
and random Fourier features), the tree ensembles, XGBoost / LightGBM /
CatBoost, anomaly detection, time series and ARIMA, the ALS
recommender, the neural network and Q-learning), with the same names,
hyperparameters, defaults and model trees. Import side effects only.
"""

from __future__ import annotations

from typing import Dict

import torch

from neurondb_tpu_torch.ml import boosting as BO
from neurondb_tpu_torch.ml import cluster_extra as CE
from neurondb_tpu_torch.ml import gmm as GMM
from neurondb_tpu_torch.ml import kmeans as KM
from neurondb_tpu_torch.ml import linear as LIN
from neurondb_tpu_torch.ml import neighbors as NB
from neurondb_tpu_torch.ml import neural as NN
from neurondb_tpu_torch.ml import pca as PCA
from neurondb_tpu_torch.ml import recommender as RC
from neurondb_tpu_torch.ml import rl as RL
from neurondb_tpu_torch.ml import timeseries as TS
from neurondb_tpu_torch.ml import trees as TR
from neurondb_tpu_torch.ml.api import Trainer, register_algorithm
from neurondb_tpu_torch.ops.vector_ops import _quantile


def _scalar(v, dtype, device) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=device)


def _num_classes(y, num_classes) -> int:
    return int(num_classes if num_classes is not None else int(y.max()) + 1)


# ---- clustering ----

def _kmeans_model(s: KM.KMeansState) -> Dict:
    dev = s.centroids.device
    return {"centroids": s.centroids,
            "inertia": _scalar(s.inertia, torch.float32, dev),
            "n_iter": _scalar(s.n_iter, torch.int32, dev)}


def _kmeans_train(X, *, k: int = 8, max_iter: int = 50, tol: float = 1e-3,
                  seed: int = 0, init: str = "kmeans++"):
    return _kmeans_model(KM.kmeans_fit(X, k, max_iter=max_iter, tol=tol,
                                       seed=seed, init=init))


def _kmeans_eval(model, X, y=None) -> Dict:
    labels = KM.kmeans_predict(model["centroids"], X)
    k = model["centroids"].shape[0]
    return {"inertia": model["inertia"],
            "silhouette": KM.silhouette_score(X, labels, k),
            "davies_bouldin": KM.davies_bouldin_index(X, labels, k)}


register_algorithm(Trainer(
    "kmeans", _kmeans_train,
    lambda m, X: KM.kmeans_predict(m["centroids"], X),
    _kmeans_eval, task="unsupervised"))


def _mbk_train(X, *, k: int = 8, batch: int = 1024, iters: int = 100,
               seed: int = 0):
    return _kmeans_model(KM.minibatch_kmeans_fit(X, k, batch=batch,
                                                 iters=iters, seed=seed))


register_algorithm(Trainer(
    "minibatch_kmeans", _mbk_train,
    lambda m, X: KM.kmeans_predict(m["centroids"], X),
    _kmeans_eval, task="unsupervised"))


# ---- linear family ----

register_algorithm(Trainer(
    "linear_regression",
    lambda X, y, **hp: LIN.linear_regression_fit(X, y, **hp),
    LIN.linear_regression_predict,
    LIN.regression_metrics))

register_algorithm(Trainer(
    "ridge",
    lambda X, y, *, alpha=1.0, **hp: LIN.linear_regression_fit(
        X, y, l2=alpha, **hp),
    LIN.linear_regression_predict,
    LIN.regression_metrics))

register_algorithm(Trainer(
    "lasso",
    lambda X, y, *, alpha=1.0, iters=500: LIN.lasso_fit(
        X, y, l1=alpha, iters=iters),
    LIN.linear_regression_predict,
    LIN.regression_metrics))

register_algorithm(Trainer(
    "elastic_net",
    lambda X, y, **hp: LIN.elastic_net_fit(X, y, **hp),
    LIN.linear_regression_predict,
    LIN.regression_metrics))


def _logreg_train(X, y, *, l2=1e-4, iters=50, num_classes=None):
    return LIN.logistic_regression_fit(
        X, y, l2=l2, iters=iters,
        num_classes=max(_num_classes(y, num_classes), 2))


register_algorithm(Trainer(
    "logistic_regression", _logreg_train,
    LIN.logistic_predict,
    lambda m, X, y: LIN.classification_metrics(m, X, y)))


# ---- gmm / pca / dbscan / hierarchical ----

def _gmm_train(X, *, k: int = 4, iters: int = 100, seed: int = 0):
    s = GMM.gmm_fit(X, k, iters=iters, seed=seed)
    return {"means": s.means, "variances": s.variances,
            "weights": s.weights, "log_likelihood": s.log_likelihood}


def _gmm_state(m):
    return GMM.GMMState(m["means"], m["variances"], m["weights"],
                        m["log_likelihood"])


register_algorithm(Trainer(
    "gmm", _gmm_train,
    lambda m, X: GMM.gmm_predict(_gmm_state(m), X),
    lambda m, X, y=None: {"log_likelihood": m["log_likelihood"]},
    task="unsupervised"))

register_algorithm(Trainer(
    "pca",
    lambda X, *, n_components=2, whiten=False: PCA.pca_fit(
        X, n_components, whiten=whiten),
    PCA.pca_transform,
    lambda m, X, y=None: {
        "explained_variance_ratio_sum":
            float(m["explained_variance_ratio"].sum())},
    task="unsupervised"))

register_algorithm(Trainer(
    "dbscan",
    lambda X, **hp: CE.dbscan_fit(X, **hp),
    CE.dbscan_predict,
    None, task="unsupervised"))

register_algorithm(Trainer(
    "hierarchical",
    lambda X, *, n_clusters=2: CE.agglomerative_fit(X, n_clusters),
    lambda m, X: KM.kmeans_predict(m["centroids"][m["active"]], X),
    None, task="unsupervised"))


# ---- knn / naive bayes / svm ----

register_algorithm(Trainer(
    "knn_classifier",
    lambda X, y, *, k=5: NB.knn_fit(X, y, k=k, task="classify"),
    NB.knn_predict,
    lambda m, X, y: LIN.classification_metrics(m, X, y, NB.knn_predict)))


def _knn_reg_eval(m, X, y):
    pred = NB.knn_predict(m, X)
    yv = y.float()
    mse = ((pred - yv) ** 2).mean()
    return {"mse": mse,
            "r2": 1.0 - mse / torch.clamp(yv.var(correction=0), min=1e-30)}


register_algorithm(Trainer(
    "knn_regressor",
    lambda X, y, *, k=5: NB.knn_fit(X, y, k=k, task="regress"),
    NB.knn_predict, _knn_reg_eval))


def _nb_train(X, y, *, num_classes=None, var_smoothing=1e-9):
    return NB.naive_bayes_fit(X, y, num_classes=_num_classes(y, num_classes),
                              var_smoothing=var_smoothing)


register_algorithm(Trainer(
    "naive_bayes", _nb_train,
    NB.naive_bayes_predict,
    lambda m, X, y: LIN.classification_metrics(m, X, y,
                                               NB.naive_bayes_predict)))


def _svm_train(X, y, *, num_classes=None, C=1.0, iters=None,
               kernel="linear", gamma=1.0, degree=3, coef0=1.0,
               solver=None, rff=256, sample_cap=8192, seed=0):
    """kernel != "linear" trains the exact dual solver (support-vector
    semantics, ml_svm.c parity) unless solver="rff" asks for the
    random-Fourier-feature approximation (faster at large n)."""
    nc = _num_classes(y, num_classes)
    if solver is None:
        solver = "primal" if kernel == "linear" else "dual"
    if solver == "rff":
        Xf = NB.rbf_features(X, n_features=rff, gamma=gamma, seed=seed)
        m = NB.svm_fit(Xf, y, num_classes=max(nc, 2), C=C,
                       iters=int(iters or 300))
        dev = X.device
        m["rbf"] = {"gamma": _scalar(float(gamma), torch.float32, dev),
                    "rff": _scalar(int(rff), torch.int32, dev),
                    "seed": _scalar(int(seed), torch.int32, dev)}
        return m
    if solver == "dual":
        return NB.svm_kernel_fit(
            X, y, num_classes=max(nc, 2), C=C, kernel=kernel, gamma=gamma,
            degree=degree, coef0=coef0, iters=int(iters or 500),
            sample_cap=sample_cap, seed=seed)
    return NB.svm_fit(X, y, num_classes=max(nc, 2), C=C,
                      iters=int(iters or 300))


def _svm_predict(m, X):
    if "sv" in m:
        return NB.svm_kernel_predict(m, X)
    if "rbf" in m:
        X = NB.rbf_features(X, n_features=int(m["rbf"]["rff"]),
                            gamma=float(m["rbf"]["gamma"]),
                            seed=int(m["rbf"]["seed"]))
    return NB.svm_predict(m, X)


register_algorithm(Trainer(
    "svm", _svm_train, _svm_predict,
    lambda m, X, y: LIN.classification_metrics(m, X, y, _svm_predict)))


# ---- trees ----

def _tree_eval(m, X, y):
    pred = TR.ensemble_predict(m, X)
    if bool(m["task_classify"]):
        return {"accuracy": (pred == y.to(torch.int32)).float().mean()}
    yv = y.float()
    mse = ((pred - yv) ** 2).mean()
    return {"mse": mse,
            "r2": 1.0 - mse / torch.clamp(yv.var(correction=0), min=1e-30)}


register_algorithm(Trainer(
    "decision_tree",
    lambda X, y, **hp: TR.decision_tree_fit(X, y, **hp),
    TR.ensemble_predict, _tree_eval))

register_algorithm(Trainer(
    "random_forest",
    lambda X, y, **hp: TR.random_forest_fit(X, y, **hp),
    TR.ensemble_predict, _tree_eval))

register_algorithm(Trainer(
    "gradient_boosting",
    lambda X, y, **hp: TR.gradient_boosting_fit(X, y, **hp),
    TR.ensemble_predict, _tree_eval))


# ---- per-library boosting semantics (ml/boosting.py) ----

_BOOST_PREDICT = {"xgboost": BO.xgboost_predict,
                  "lightgbm": BO.lightgbm_predict,
                  "catboost": BO.catboost_predict}


def _boost_eval(model, X, y):
    pred = _BOOST_PREDICT[model["algo"]](model, X)
    if model["task"] == "classify":
        return {"accuracy": float((pred == y.to(torch.int32)).float().mean())}
    y = y.float()
    p = pred.float().reshape(y.shape)
    ss = ((y - p) ** 2).sum()
    st = ((y - y.mean()) ** 2).sum()
    return {"mse": float(ss / max(len(y), 1)),
            "r2": float(1.0 - ss / torch.clamp(st, min=1e-12))}


for _name, _fit in (("xgboost", BO.xgboost_fit),
                    ("lightgbm", BO.lightgbm_fit),
                    ("catboost", BO.catboost_fit)):
    register_algorithm(Trainer(
        _name, lambda X, y, _fit=_fit, **hp: _fit(X, y, **hp),
        _BOOST_PREDICT[_name], _boost_eval))


# ---- anomaly detection ----

def _anomaly_train(X, *, method="knn", k=5, threshold=3.0, contamination=0.1):
    X = X.float()
    dev = X.device
    if method == "zscore":
        return {"method": "zscore", "mean": X.mean(0),
                "std": X.std(0, correction=0),
                "threshold": _scalar(float(threshold), torch.float32, dev)}
    scores = CE.knn_outlier_scores(X, k=k)
    cut = _quantile(scores, 1.0 - contamination)
    return {"method": "knn", "X": X,
            "k": _scalar(int(k), torch.int32, dev), "cutoff": cut}


def _anomaly_predict(m, X):
    X = X.float()
    if m["method"] == "zscore":
        z = (X - m["mean"]).abs() / torch.clamp(m["std"], min=1e-12)
        return (z > m["threshold"]).any(1)
    d, _ = NB._knn_neighbors(m, X, int(m["k"]))
    return d.mean(1) > m["cutoff"]


register_algorithm(Trainer(
    "anomaly_detection", _anomaly_train, _anomaly_predict,
    None, task="unsupervised"))


# ---- timeseries (series-as-X convention: X is the 1-D series) ----

def _ts_train(X, *, order=4, method="ar", season=12, p=1, d=1, q=1):
    y = X.float().reshape(-1)
    if method == "holt_winters":
        m = TS.holt_winters_fit(y, season=season)
        m["method"] = "holt_winters"
    elif method == "arima":
        m = TS.arima_fit(y, p=p, d=d, q=q)
        m["method"] = "arima"
    else:
        m = TS.ar_fit(y, order=order)
        m["method"] = "ar"
        m["tail"] = y[-order:]
    return m


def _ts_predict(m, X):
    steps = int(X.reshape(-1)[0]) if X.numel() else 8
    if m["method"] == "holt_winters":
        return TS.holt_winters_forecast(m, steps=steps)
    if m["method"] == "arima":
        return TS.arima_forecast(m, steps=steps)
    return TS.ar_forecast(m, m["tail"], steps=steps)


register_algorithm(Trainer(
    "timeseries", _ts_train, _ts_predict, None, task="unsupervised"))

register_algorithm(Trainer(
    "arima",
    lambda X, **hp: _ts_train(X, method="arima", **hp),
    _ts_predict, None, task="unsupervised"))


# ---- recommender (X = [user, item, rating] triples) ----

def _rec_train(X, *, factors=16, iters=10, l2=0.1, seed=0):
    t = X.float()
    users = t[:, 0].long()
    items = t[:, 1].long()
    U, I = int(users.max()) + 1, int(items.max()) + 1
    R = torch.zeros((U, I), device=X.device)
    M = torch.zeros((U, I), device=X.device)
    R[users, items] = t[:, 2]
    M[users, items] = 1.0
    return RC.als_fit(R, M, factors=factors, iters=iters, l2=l2, seed=seed)


def _rec_predict(m, X):
    t = X.long()
    return RC.predict_ratings(m)[t[:, 0], t[:, 1]]


register_algorithm(Trainer(
    "recommender", _rec_train, _rec_predict, None, task="unsupervised"))


# ---- neural network (aliases mlp / deeplearning / deep_learning in
# ml/api.py) ----

def _nn_eval(m, X, y):
    pred = NN.mlp_predict(m, X)
    if bool(m["classify"]):
        return {"accuracy": (pred == y.to(torch.int32)).float().mean()}
    yv = y.float()
    mse = ((pred - yv) ** 2).mean()
    return {"mse": mse,
            "r2": 1.0 - mse / torch.clamp(yv.var(correction=0), min=1e-30)}


register_algorithm(Trainer(
    "neural_network",
    lambda X, y, **hp: NN.mlp_fit(X, y, **hp),
    NN.mlp_predict, _nn_eval))


# ---- reinforcement learning ----

def _rl_train(X, *, n_states=None, n_actions=None, alpha=0.1, gamma=0.95,
              epochs=50):
    t = X.float()
    ns = int(n_states if n_states is not None
             else max(float(t[:, 0].max()), float(t[:, 3].max())) + 1)
    na = int(n_actions if n_actions is not None
             else float(t[:, 1].max()) + 1)
    return {"Q": RL.q_learning_fit(t, n_states=ns, n_actions=na,
                                   alpha=alpha, gamma=gamma, epochs=epochs)}


register_algorithm(Trainer(
    "reinforcement_learning", _rl_train,
    lambda m, X: m["Q"][X.to(torch.int32).reshape(-1).long()].argmax(1).to(
        torch.int32),
    None, task="unsupervised"))
